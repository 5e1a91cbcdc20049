"""gRPC debuginfo upload client (parca debuginfo v1alpha1 flow).

Implements the DebuginfoManager's client protocol over the server-side
upload conversation the reference drives through generated stubs
(pkg/debuginfo/client.go + parca's debuginfo service):

  exists():  ShouldInitiateUpload(build_id, hash) — server answers whether
             it wants this build id at all;
  upload():  InitiateUpload(build_id, hash, size) -> upload_id, then a
             client-streaming Upload(info, chunks...), then
             MarkUploadFinished(build_id, upload_id).

Wire messages are hand-rolled like the rest of the transport (schema
subset of parca's debuginfo/v1alpha1/debuginfo.proto; the grpc channel is
shared machinery with agent/grpc_client.py).

The port's copy of parca_agent_tpu's agent/debuginfo_client.py.
"""

from __future__ import annotations

from parca_agent_tpu_torch.pprof.proto import iter_fields, put_tag_bytes, put_tag_varint

SVC = "/parca.debuginfo.v1alpha1.DebuginfoService"
SHOULD_INITIATE = f"{SVC}/ShouldInitiateUpload"
INITIATE = f"{SVC}/InitiateUpload"
UPLOAD = f"{SVC}/Upload"
MARK_FINISHED = f"{SVC}/MarkUploadFinished"

_CHUNK = 1 << 20  # 1 MiB per streamed chunk


def _enc_should_initiate(build_id: str, hash_: str) -> bytes:
    out = bytearray()
    put_tag_bytes(out, 1, build_id.encode())
    put_tag_bytes(out, 2, hash_.encode())
    return bytes(out)


def _dec_should_initiate(data: bytes) -> bool:
    for field, wt, value in iter_fields(data):
        if field == 1 and wt == 0:
            return bool(value)
    return False


def _enc_initiate(build_id: str, hash_: str, size: int) -> bytes:
    out = bytearray()
    put_tag_bytes(out, 1, build_id.encode())
    put_tag_varint(out, 2, size)
    put_tag_bytes(out, 3, hash_.encode())
    return bytes(out)


def _dec_initiate_upload_id(data: bytes) -> str:
    # InitiateUploadResponse{ UploadInstructions upload_instructions = 1 }
    # UploadInstructions{ build_id = 1; upload_id = 2; ... }
    for field, wt, value in iter_fields(data):
        if field == 1 and wt == 2:
            for f2, w2, v2 in iter_fields(value):
                if f2 == 2 and w2 == 2:
                    return v2.decode()
    return ""


def _enc_upload_info(build_id: str, upload_id: str) -> bytes:
    info = bytearray()
    put_tag_bytes(info, 1, build_id.encode())
    put_tag_bytes(info, 2, upload_id.encode())
    out = bytearray()
    put_tag_bytes(out, 1, bytes(info))  # oneof data { UploadInfo info = 1; }
    return bytes(out)


def _enc_upload_chunk(chunk: bytes) -> bytes:
    out = bytearray()
    put_tag_bytes(out, 2, chunk)  # oneof data { bytes chunk_data = 2; }
    return bytes(out)


def _enc_mark_finished(build_id: str, upload_id: str) -> bytes:
    out = bytearray()
    put_tag_bytes(out, 1, build_id.encode())
    put_tag_bytes(out, 2, upload_id.encode())
    return bytes(out)


class GRPCDebuginfoClient:
    """DebuginfoManager client over a shared grpc channel.

    `channel` may also be a zero-arg CALLABLE returning the channel:
    stub construction is then deferred to the first RPC, so a channel
    whose own construction dials the server (the store client's
    skip-verify cert fetch) cannot turn agent startup into a crash when
    the store is transiently down — the manager's per-upload error
    handling absorbs the raise and retries after its TTL."""

    def __init__(self, channel, timeout_s: float = 60.0):
        self._timeout = timeout_s
        self._should = None
        if callable(channel):
            self._channel_provider = channel
        else:
            self._channel_provider = lambda: channel
            self._make_stubs(channel)

    def _make_stubs(self, channel) -> None:
        ident = lambda b: b  # noqa: E731 - raw-bytes (de)serializers
        # self._should doubles as the initialized sentinel for the
        # manager's concurrent workers: assign it LAST so no thread can
        # observe a partially-stubbed client.
        self._initiate = channel.unary_unary(
            INITIATE, request_serializer=ident, response_deserializer=ident)
        self._upload = channel.stream_unary(
            UPLOAD, request_serializer=ident, response_deserializer=ident)
        self._mark = channel.unary_unary(
            MARK_FINISHED, request_serializer=ident,
            response_deserializer=ident)
        self._should = channel.unary_unary(
            SHOULD_INITIATE, request_serializer=ident,
            response_deserializer=ident)

    def _ensure_stubs(self) -> None:
        if self._should is None:
            self._make_stubs(self._channel_provider())

    def exists(self, build_id: str, hash_: str) -> bool:
        self._ensure_stubs()
        resp = self._should(_enc_should_initiate(build_id, hash_),
                            timeout=self._timeout)
        return not _dec_should_initiate(resp)

    def upload(self, build_id: str, hash_: str, data: bytes) -> None:
        self._ensure_stubs()
        resp = self._initiate(_enc_initiate(build_id, hash_, len(data)),
                              timeout=self._timeout)
        upload_id = _dec_initiate_upload_id(resp)

        def chunks():
            yield _enc_upload_info(build_id, upload_id)
            for off in range(0, len(data), _CHUNK):
                yield _enc_upload_chunk(data[off: off + _CHUNK])

        self._upload(chunks(), timeout=self._timeout)
        self._mark(_enc_mark_finished(build_id, upload_id),
                   timeout=self._timeout)
