"""Positive fixture: transport frames bytes; the engine adopts pages on
its own decode loop via the committed-migration queue."""
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
    def migrate_put(self, token, payload):  # lands in HOST tier, under lock
        self._migrations[token] = payload

    @decode_loop_only
    def poll_migrations(self):
        for payload in self._migrations.values():
            self.cache.commit_pages(payload)    # decode loop owns pools


@cube_transport
def send_frame(stream, msg):
    stream.write(_encode(msg))              # bytes only — fine


@cube_transport
def recv_frame(stream):
    return _decode(stream.read())


def _encode(msg):
    return repr(msg).encode()


def _decode(blob):
    return blob.decode()


def worker_handle(engine, stream):
    # NOT transport-marked: the worker's message handler runs ON the
    # decode-loop thread and may use the engine's landing API
    msg = recv_frame(stream)
    engine.migrate_put("t", msg)
    engine.poll_migrations()
