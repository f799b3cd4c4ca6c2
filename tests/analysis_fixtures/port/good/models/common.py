"""Positive fixture: tree helpers shaped like ``repro_torch.models.common``."""


def tree_items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree
