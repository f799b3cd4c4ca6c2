"""Rule registry for the port's repro-lint.  Each rule module exposes
``RULES`` (the rule-id strings it can emit) and ``check(files) ->
list[Finding]``."""
from . import (
    capture_safety,
    cube_boundary,
    device_under_lock,
    obs_hot_path,
    phase_transitions,
    sole_writer,
    tune_lookup,
)

ALL_RULE_MODULES = [device_under_lock, sole_writer, phase_transitions,
                    capture_safety, obs_hot_path, tune_lookup, cube_boundary]

ALL_RULE_IDS = [rid for mod in ALL_RULE_MODULES for rid in mod.RULES]
