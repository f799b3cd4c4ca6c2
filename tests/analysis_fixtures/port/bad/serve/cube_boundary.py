"""Negative fixture: the wire layer smuggling engine ownership."""
from repro_torch.analysis.ownership import (
    cube_transport,
    decode_loop_only,
    pool_mutator,
)


class Cache:
    @pool_mutator("pools")
    def commit_pages(self, pages):
        self.pools = pages


class Engine:
    @decode_loop_only
    def poll_migrations(self):
        return 0


@cube_transport
def recv_and_adopt(engine, stream):
    payload = stream.read()
    engine.cache.commit_pages(payload)      # BAD: transport-pools-call
    engine.poll_migrations()                # BAD: transport-decode-only-call
    return payload


@cube_transport
def recv_indirect(engine, stream):
    return _finish(engine, stream.read())


def _finish(engine, payload):
    # reachable from a @cube_transport root: same violations, one hop out
    engine.cache.commit_pages(payload)      # BAD: transport-pools-call
    engine.poll_migrations()                # BAD: transport-decode-only-call
    return payload
