"""gRPC ProfileStore client.

Role of the reference's grpcConn + profilestore client wiring
(cmd/parca-agent/main.go:595-656): TLS or insecure channel, optional
bearer token attached per-RPC, and the WriteRaw unary call. No generated
stubs: the request is serialized by agent/profilestore.py and sent over a
generic unary_unary handle, so the dependency stays import-gated.

The port's copy of parca_agent_tpu's agent/grpc_client.py, with one
fault of the original fixed: a batch whose WriteRaw request would pass
the channel's message cap is sent as several requests, each under it,
series by series (``write_raw_requests``). The batch client caps its
buffer at the same 64 MiB by payload and label bytes, without the
protobuf framing, so a full buffer (a spilled spool segment) encodes
past the cap: the original's send then fails on the client side
(RESOURCE_EXHAUSTED) at every retry and every replay, and the segment
never ships. A single series over the cap still fails. As with a failed
replay, a batch that fails after some of its requests were taken is sent
again whole (at least once).
"""

from __future__ import annotations

from parca_agent_tpu_torch.agent.profilestore import RawSeries, encode_write_raw_request
from parca_agent_tpu_torch.runtime import trace as window_trace
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("grpc")

WRITE_RAW_METHOD = "/parca.profilestore.v1alpha1.ProfileStoreService/WriteRaw"
DEBUGINFO_UPLOAD_METHOD = "/parca.debuginfo.v1alpha1.DebuginfoService/Upload"


# Generous message bounds like the reference's MaxCallRecvMsgSize /
# MaxCallSendMsgSize options (main.go:595-656): one batch can carry many
# gzipped profiles plus debuginfo uploads share the channel.
MAX_MSG_BYTES = 64 << 20


def write_raw_requests(series: list[RawSeries], normalized: bool,
                       max_bytes: int) -> list[bytes]:
    """The WriteRaw request of ``series``, or, when it is over
    ``max_bytes``, consecutive runs of the series each encoded as one
    request under it (a series alone over the cap is a request of its
    own)."""
    whole = encode_write_raw_request(series, normalized)
    if len(whole) <= max_bytes or len(series) < 2:
        return [whole]
    # A request is its series' fields plus the `normalized` field, so a
    # run's size is the sum of its series' encodings past that field.
    tail = len(encode_write_raw_request([], normalized))
    runs, run, size = [], [], tail
    for s in series:
        n = len(encode_write_raw_request([s], normalized)) - tail
        if run and size + n > max_bytes:
            runs.append(run)
            run, size = [], tail
        run.append(s)
        size += n
    runs.append(run)
    return [encode_write_raw_request(r, normalized) for r in runs]


def _cert_name_cryptography(pem: str) -> str:
    """Subject CN (DNS-SAN fallback) via the `cryptography` package.
    Raises ImportError when the package is absent; any parse failure
    returns "" so the caller can try the stdlib route."""
    from cryptography import x509
    from cryptography.x509.oid import ExtensionOID, NameOID

    try:
        cert = x509.load_pem_x509_certificate(pem.encode())
        cns = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
        if cns:
            return str(cns[0].value)
        san = cert.extensions.get_extension_for_oid(
            ExtensionOID.SUBJECT_ALTERNATIVE_NAME)
        dns = san.value.get_values_for_type(x509.DNSName)
        return str(dns[0]) if dns else ""
    except Exception:  # noqa: BLE001 - best-effort, stdlib fallback next
        return ""


def _cert_name_stdlib(pem: str) -> str:
    """Subject CN (DNS-SAN fallback) via CPython's private
    ssl._ssl._test_decode_cert — the only stdlib route to the subject of
    an unverified certificate. Kept as the fallback: the API is private
    and may vanish, which is why `cryptography` is tried first."""
    import ssl
    import tempfile

    name = ""
    try:
        with tempfile.NamedTemporaryFile("w", suffix=".pem") as f:
            f.write(pem)
            f.flush()
            decoded = ssl._ssl._test_decode_cert(f.name)  # noqa: SLF001
        for rdn in decoded.get("subject", ()):
            for key, value in rdn:
                if key == "commonName":
                    name = value
        if not name:  # SAN-only certs have no CN
            for kind, value in decoded.get("subjectAltName", ()):
                if kind == "DNS":
                    name = value
                    break
    except Exception:  # noqa: BLE001 - override is best-effort
        name = ""
    return name


def _cert_name(pem: str) -> str:
    """Best-effort subject name of a PEM certificate for the
    SNI/hostname override: prefer the supported `cryptography` parser
    when importable, fall back to the private stdlib decoder."""
    try:
        name = _cert_name_cryptography(pem)
        if name:
            return name
    except ImportError:
        pass
    return _cert_name_stdlib(pem)


def _fetch_server_cert(address: str, timeout_s: float = 30.0
                       ) -> tuple[bytes, str]:
    """(PEM cert, subject common name) of the TLS server at address,
    fetched WITHOUT verification (the point: the caller asked to skip
    it). The returned name (subject CN, falling back to the first DNS
    SAN) lets the caller override SNI/hostname checking against the
    pinned cert."""
    import ssl

    host, port = _split_host_port(address)
    # Bounded: this fetch runs under the client's channel lock — an
    # unbounded dial against a black-holed address would hang every
    # writer and debuginfo worker, not just this call.
    pem = ssl.get_server_certificate((host, port), timeout=timeout_s)
    name = _cert_name(pem)
    if not name:
        # Without a derived name the hostname check runs against the
        # dial address; a CN/SAN mismatch then fails the handshake even
        # though the cert is pinned — worth a log line, not a crash.
        _log.warn("could not derive a subject name from the pinned "
                  "server certificate; skipping the hostname override",
                  address=address)
    return pem.encode(), name


def _split_host_port(address: str, default_port: int = 443
                     ) -> tuple[str, int]:
    """host:port / bare-host / [v6]:port / bare-[v6] -> (host, port)."""
    if address.startswith("["):
        host, _, rest = address[1:].partition("]")
        return host, int(rest.lstrip(":") or default_port)
    host, sep, port = address.rpartition(":")
    if not sep:
        return address, default_port
    if port == "":
        return host, default_port  # trailing colon: "host:"
    if not port.isdigit():
        return address, default_port
    return host, int(port)


class GRPCStoreClient:
    def __init__(self, address: str, insecure: bool = False,
                 insecure_skip_verify: bool = False,
                 bearer_token: str = "", timeout_s: float = 30.0,
                 max_msg_bytes: int = MAX_MSG_BYTES,
                 reset_after_unavailable: int = 3):
        try:
            import grpc
        except ImportError as e:  # pragma: no cover - grpc is in the image
            raise RuntimeError("grpc package unavailable") from e
        import threading

        self._grpc = grpc
        self._timeout = timeout_s
        self._address = address
        self._insecure = insecure
        self._skip_verify = insecure_skip_verify
        self._token = bearer_token
        self._max_msg_bytes = max_msg_bytes
        self._options = [
            ("grpc.max_send_message_length", max_msg_bytes),
            ("grpc.max_receive_message_length", max_msg_bytes),
        ]
        self._bearer = bearer_token if insecure else ""
        # Channel construction is LAZY (first RPC): grpc channels are
        # lazy by themselves, but the skip-verify path must dial the
        # server for its certificate — doing that in __init__ would turn
        # a transiently unreachable store into an agent startup crash,
        # where the normal path starts and retries. A failed build is
        # re-attempted on the next RPC (the batch writer's backoff and
        # the debuginfo manager's error handling both absorb the raise).
        self._lock = threading.Lock()
        self._channel_obj = None   # guarded-by: _lock
        self._write_raw_m = None   # guarded-by: _lock
        # Channel-reset policy: skip-verify pins the
        # server certificate at first use, so a server cert rotation
        # makes every internal reconnect fail TLS until the channel is
        # rebuilt — the reference's InsecureSkipVerify accepts any cert
        # on every handshake and never gets stuck. Reset the lazy channel
        # on handshake-class RPC failures, or after N consecutive
        # UNAVAILABLE errors (how grpc-python surfaces a failed TLS
        # handshake on reconnect), so the next RPC re-fetches and re-pins
        # the current certificate.
        self._reset_after_unavailable = max(1, reset_after_unavailable)
        # Failure bookkeeping is mutated from the writer's flush thread
        # AND the debuginfo workers; its own lock (not the channel lock:
        # _note_rpc_failure calls close(), which takes the channel lock —
        # sharing one would deadlock).
        self._stats_lock = threading.Lock()
        self._consec_unavailable = 0            # guarded-by: _stats_lock
        self.stats = {"channel_resets": 0}      # guarded-by: _stats_lock

    def _build_channel(self):
        grpc = self._grpc
        options = list(self._options)
        faults.inject("grpc.handshake")
        if self._insecure:
            return grpc.insecure_channel(self._address, options=options)
        if self._skip_verify:
            # The reference's --remote-store-insecure-skip-verify
            # (InsecureSkipVerify TLS). grpc-python has no direct switch,
            # so implement the same trust model explicitly: fetch the
            # server's certificate over an UNVERIFIED handshake and pin
            # it as the channel's root CA — encrypted transport, no
            # authentication (trust on first use for the channel's
            # lifetime). The certificate's own subject/SAN overrides the
            # hostname check for the same reason. Covers the flag's
            # dominant case (self-signed server certs); a chain from an
            # unknown CA still fails — OpenSSL will not treat a
            # non-self-signed leaf as a trust anchor, and grpc-python
            # exposes no partial-chain switch.
            cert, name = _fetch_server_cert(self._address,
                                            timeout_s=self._timeout)
            if name:
                options.append(("grpc.ssl_target_name_override", name))
            creds = self._grpc.ssl_channel_credentials(
                root_certificates=cert)
        else:
            creds = grpc.ssl_channel_credentials()
        if self._token:
            call_creds = grpc.access_token_call_credentials(self._token)
            creds = grpc.composite_channel_credentials(creds, call_creds)
        return grpc.secure_channel(self._address, creds, options=options)

    @property
    def channel(self):
        """Shared by the debuginfo client (one connection per server,
        like the reference's single grpcConn, main.go:595-656). Built on
        first access; a failed build raises to the caller and is retried
        on the next access."""
        with self._lock:
            if self._channel_obj is None:
                self._channel_obj = self._build_channel()
            return self._channel_obj

    def _write_raw_method(self):
        """The WriteRaw callable, built (with its channel) under the
        channel lock and returned as a LOCAL reference: a concurrent
        close()/reset can null the cached attribute at any time, so
        callers must never read it twice."""
        with self._lock:
            if self._channel_obj is None:
                self._channel_obj = self._build_channel()
            if self._write_raw_m is None:
                self._write_raw_m = self._channel_obj.unary_unary(
                    WRITE_RAW_METHOD,
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b,
                )
            return self._write_raw_m

    def write_raw(self, series: list[RawSeries], normalized: bool) -> None:
        method = self._write_raw_method()
        metadata = []
        if self._bearer:
            # Insecure channels can't carry call credentials; send the
            # token as plain metadata like the reference's perRequestBearerToken
            # with insecure=true (main.go:620-637).
            metadata.append(("authorization", f"Bearer {self._bearer}"))
        try:
            # The chaos site sits inside the failure classifier's scope so
            # an injected UNAVAILABLE/handshake drives the same reset
            # bookkeeping a real RPC failure would.
            faults.inject("grpc.write_raw")
            import time as _time

            t0 = _time.perf_counter()
            for request in write_raw_requests(series, normalized,
                                              self._max_msg_bytes):
                method(request, timeout=self._timeout,
                       metadata=metadata or None)
            # The raw RPC alone (store_ack, one layer up in the batch
            # client, additionally covers serialization + channel build).
            window_trace.observe("store_rpc", _time.perf_counter() - t0)
        except Exception as e:
            self._note_rpc_failure(e)
            raise
        with self._stats_lock:
            self._consec_unavailable = 0

    def _note_rpc_failure(self, e: Exception) -> None:
        """Reset-on-failure bookkeeping (see __init__): a handshake-class
        error, or reset_after_unavailable consecutive UNAVAILABLEs, drops
        the built channel so the next RPC re-dials (and, under
        skip-verify, re-fetches and re-pins the server's current cert).
        Insecure channels have nothing to re-pin and are left alone."""
        if self._insecure:
            return
        detail = ""
        for attr in ("details", "debug_error_string"):
            try:
                detail += " " + str(getattr(e, attr)() or "")
            except Exception:  # noqa: BLE001 - non-grpc exceptions
                pass
        detail = (detail or repr(e)).lower()
        handshake = any(s in detail for s in (
            "handshake", "ssl", "certificate", "authentication"))
        unavailable = False
        try:
            unavailable = e.code() == self._grpc.StatusCode.UNAVAILABLE
        except Exception:  # noqa: BLE001 - non-grpc exceptions
            pass
        # Decide-and-count under the stats lock: writer + debuginfo
        # threads race through here, and an unguarded read-modify-write
        # both loses counts and can double-reset the channel.
        with self._stats_lock:
            if unavailable:
                self._consec_unavailable += 1
            reset = handshake or (unavailable and self._consec_unavailable
                                  >= self._reset_after_unavailable)
            if reset:
                self._consec_unavailable = 0
                self.stats["channel_resets"] += 1
        if reset:
            _log.warn("resetting gRPC channel after RPC failure "
                      "(re-pinning the server certificate on rebuild)",
                      address=self._address,
                      handshake_class=handshake, error=repr(e)[:200])
            self.close()

    def close(self) -> None:
        with self._lock:
            if self._channel_obj is not None:
                self._channel_obj.close()
                self._channel_obj = None
                self._write_raw_m = None
