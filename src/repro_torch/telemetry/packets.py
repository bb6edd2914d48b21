"""Evidence-packet serialization — the paper's 0.11 MB artifact.

The dense root-visible payload is B_root = R*N*K*b bytes (§5).  A packet
carries the window's rank-stage matrix (or only its summary, in `compact`
mode), the diagnosis, and provenance (schema hash, window index, gather
status).  Two wire framings are supported:

* **SFP2** (default) — the zero-copy format.  Every section is length-
  prefixed and bounds-checked against the buffer before it is sliced;
  trailing bytes are rejected; the float64 window payload decodes as a
  read-only zero-copy view into the wire buffer (`memoryview`-based, no
  payload copy).  The int8 window payload ships either raw (`int8`, the
  fleet default) or step-delta'd + zigzag-varint'd (`int8.delta`, for
  transports that want byte-stream smoothness); both dequantize to the
  exact same float64 window.  The header is built field-by-field — no
  `dataclasses.asdict`, which deep-copied the full window on SFP1 —
  present ranks travel as a binary u32 section, and the payload is
  guarded by an adler32 checksum (corruption detection on a monitoring
  wire, not an authentication boundary; ~2x cheaper than SFP1's
  truncated sha256 at the 0.1 MB scale).
* **SFP1** — the legacy framing kept for back-compat: every packet
  produced by older emitters still decodes bit-for-bit (golden fixtures
  in `tests/golden/` pin the byte format).  Its decoder now applies the
  same strict bounds (declared lengths validated, trailing garbage after
  a compact packet rejected) without changing what valid packets decode
  to.

Byte layouts are documented in docs/architecture.md; the encode/decode
throughput gates live in `benchmarks/wire_path.py` (paper Table 6
measures the artifact against a full per-step trace).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
import zlib
from typing import Any

import numpy as np

from ..core.labeler import Diagnosis
from ..distributed.compression import (
    delta_varint_decode_i8,
    delta_varint_encode_i8,
    quantize_i8,
)

__all__ = ["EvidencePacket", "encode_packet", "decode_packet"]

_MAGIC = b"SFP1"
_MAGIC2 = b"SFP2"
#: SFP2 wire versions this decoder accepts.  v1 is the base framing; v2
#: appends an optional binary host-id section (per-rank host names, the
#: incident tier's topology source) between the present-ranks section
#: and the window payload; v3 appends an optional topology section after
#: the host section — per-rank switch and pod names, the fabric tiers
#: the incident engine promotes over.  The encoder emits the LOWEST
#: version that carries the packet's declared placement: hostless
#: packets stay byte-identical v1, host-only packets byte-identical v2
#: (golden fixtures in `tests/golden/` pin all three framings).
_SFP2_VERSION = 1
_SFP2_VERSION_HOSTS = 2
_SFP2_VERSION_FABRIC = 3
_FLAG_WINDOW = 0x01
#: compress= -> (meta dtype tag, optional payload codec tag)
_COMPRESSIONS = ("none", "int8", "int8.delta")
#: hard cap on any declared window: 2^31 cells (~16 GiB f64) — a corrupt
#: shape must fail the bounds check, never reach an allocation.
_MAX_CELLS = 1 << 31


@dataclasses.dataclass(frozen=True)
class EvidencePacket:
    window_index: int
    schema_hash: str
    stages: tuple[str, ...]
    steps: int
    world_size: int
    gather_ok: bool
    labels: tuple[str, ...]
    routing_stages: tuple[str, ...]
    shares: tuple[float, ...]
    gains: tuple[float, ...]
    co_critical_stages: tuple[str, ...]
    downgrade_reasons: tuple[str, ...]
    leader_rank: int
    #: ranks that contributed to the window gather; () = all present.
    present_ranks: tuple[int, ...] = ()
    #: window denominator sum_t F[t,S] (seconds); converts the relative
    #: gains G_s into recoverable seconds fleet-side.  -1.0 = unknown
    #: (packets from pre-whatif emitters decode with this default).
    exposed_total: float = -1.0
    #: stage names that end with a group synchronization (the job's sync
    #: profile: DDP/FSDP/ZeRO-1 declare different barriers).  Drives the
    #: fleet-side counterfactual replay (`core.whatif` sync model); () =
    #: undeclared, the what-if engine falls back to pure substitution.
    sync_stages: tuple[str, ...] = ()
    #: job-global step index of the window's first step.  Lets the fleet
    #: tier stitch windows into one continuous step history, so the
    #: temporal regime engine (`core.regimes`) reports fault onsets in
    #: the job's own step coordinates.  -1 = undeclared (pre-regime
    #: emitters decode with this default).
    first_step: int = -1
    #: per-rank host names (the job's physical placement).  Feeds the
    #: incident tier's `Topology` so faults correlate across jobs by
    #: host.  Ships as a binary SFP2-v2 section; () = undeclared
    #: (pre-incident emitters decode with this default, and packets
    #: without hosts still encode as byte-identical SFP2 v1).
    hosts: tuple[str, ...] = ()
    #: per-rank switch names (the fabric tier above each rank's host).
    #: Ships in the binary SFP2-v3 topology section; () = undeclared
    #: (host-only packets still encode as byte-identical SFP2 v2).
    #: Requires `hosts` and must align with it per rank.
    switches: tuple[str, ...] = ()
    #: per-rank pod names (the fabric tier above each rank's switch).
    #: Same v3 section and discipline; requires `switches`.
    pods: tuple[str, ...] = ()
    #: full [N, R, S] matrix (None in compact mode)
    window: np.ndarray | None = None

    @property
    def payload_bytes(self) -> int:
        return len(encode_packet(self))


def from_diagnosis(
    diag: Diagnosis,
    stages: tuple[str, ...],
    steps: int,
    world_size: int,
    window_index: int,
    window: np.ndarray | None = None,
    present_ranks: tuple[int, ...] = (),
    sync_stages: tuple[str, ...] = (),
    first_step: int = -1,
    hosts: tuple[str, ...] = (),
    switches: tuple[str, ...] = (),
    pods: tuple[str, ...] = (),
) -> EvidencePacket:
    return EvidencePacket(
        window_index=window_index,
        schema_hash=diag.schema_hash,
        stages=stages,
        steps=steps,
        world_size=world_size,
        gather_ok=diag.gather_ok,
        labels=diag.labels,
        routing_stages=diag.routing_stages,
        shares=diag.shares,
        gains=diag.gains,
        co_critical_stages=diag.co_critical_stages,
        downgrade_reasons=diag.downgrade_reasons,
        leader_rank=diag.leader.leader_rank if diag.leader else -1,
        present_ranks=tuple(present_ranks),
        exposed_total=diag.exposed_makespan_total,
        sync_stages=tuple(sync_stages),
        first_step=first_step,
        hosts=tuple(hosts),
        switches=tuple(switches),
        pods=tuple(pods),
        window=window,
    )


# ---------------------------------------------------------------------------
# header (shared): built field-by-field — never dataclasses.asdict, which
# deep-copies every field (including the full [N, R, S] float64 window)
# only for the window to be filtered back out.
# ---------------------------------------------------------------------------


def _header_dict(p: EvidencePacket, *, present_ranks: bool) -> dict[str, Any]:
    """Wire header in dataclass field order (SFP1 byte compatibility);
    SFP2 carries present_ranks in a binary section instead."""
    h: dict[str, Any] = {
        "window_index": p.window_index,
        "schema_hash": p.schema_hash,
        "stages": p.stages,
        "steps": p.steps,
        "world_size": p.world_size,
        "gather_ok": p.gather_ok,
        "labels": p.labels,
        "routing_stages": p.routing_stages,
        "shares": p.shares,
        "gains": p.gains,
        "co_critical_stages": p.co_critical_stages,
        "downgrade_reasons": p.downgrade_reasons,
        "leader_rank": p.leader_rank,
    }
    if present_ranks:
        h["present_ranks"] = p.present_ranks
    h["exposed_total"] = p.exposed_total
    h["sync_stages"] = p.sync_stages
    h["first_step"] = p.first_step
    return h


def _window_payload(
    p: EvidencePacket, compress: str
) -> tuple[dict[str, Any], Any]:
    """(meta dict, payload buffer) for the window section."""
    w = np.ascontiguousarray(p.window, np.dtype("<f8"))
    if compress == "none":
        return {"shape": w.shape, "dtype": "float64"}, memoryview(w).cast("B")
    q, scale = quantize_i8(w, axis=-1)
    meta: dict[str, Any] = {
        "shape": w.shape,
        "dtype": "int8",
        "scales": [float(v) for v in np.atleast_1d(scale)],
    }
    if compress == "int8.delta":
        meta["codec"] = "delta"
        return meta, delta_varint_encode_i8(q)
    return meta, memoryview(np.ascontiguousarray(q)).cast("B")


def _validate_meta(meta: Any) -> tuple[tuple[int, ...], str, str, int]:
    """Strict window-meta validation shared by both decode routes.

    Returns (shape, dtype, codec, expected_cells); raises ValueError on
    anything malformed — in particular an oversized / non-integer shape
    is rejected *before* any allocation or slicing happens.
    """
    if not isinstance(meta, dict):
        raise ValueError("window meta is not an object")
    shape_raw = meta.get("shape")
    if (
        not isinstance(shape_raw, list)
        or not shape_raw
        or len(shape_raw) > 8
        or not all(isinstance(v, int) and 0 <= v <= _MAX_CELLS for v in shape_raw)
    ):
        raise ValueError("invalid window shape meta")
    shape = tuple(shape_raw)
    cells = 1
    for v in shape:
        cells *= v
    if cells > _MAX_CELLS:
        raise ValueError("window shape meta exceeds size cap")
    dtype = meta.get("dtype", "float64")
    if dtype not in ("float64", "int8"):
        raise ValueError(f"unknown window dtype {dtype!r}")
    codec = meta.get("codec", "raw")
    if codec not in ("raw", "delta") or (codec == "delta" and dtype != "int8"):
        raise ValueError(f"unknown window codec {codec!r}")
    if dtype == "int8":
        scales = meta.get("scales")
        if not isinstance(scales, list) or len(scales) not in (1, shape[-1]):
            raise ValueError("int8 window meta missing per-stage scales")
    return shape, dtype, codec, cells


def _decode_window(
    payload: memoryview, meta: dict[str, Any]
) -> np.ndarray:
    """Materialize the window from a validated payload slice.  float64
    payloads come back as a read-only zero-copy view into the wire
    buffer; int8 payloads dequantize into a fresh float64 array identical
    across the raw and delta codecs (and identical to SFP1's
    `dequantize_i8` route)."""
    shape, dtype, codec, cells = _validate_meta(meta)
    if dtype == "float64":
        if len(payload) != cells * 8:
            raise ValueError("window payload length does not match shape")
        return np.frombuffer(payload, np.dtype("<f8")).reshape(shape)
    if codec == "delta":
        q = delta_varint_decode_i8(payload, shape)
    else:
        if len(payload) != cells:
            raise ValueError("window payload length does not match shape")
        q = np.frombuffer(payload, np.int8).reshape(shape)
    # equivalent to dequantize_i8(q, scales, axis=-1): int8 -> f64 is
    # exact and the in-place multiply rounds identically; two passes, no
    # third temporary.
    out = q.astype(np.float64)
    np.multiply(out, np.asarray(meta["scales"], np.float64), out=out)
    return out


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _pack_names(names: tuple[str, ...], what: str) -> list[Any]:
    """Binary name-list section: u32 count + per-name u16 length + utf8.
    The ONE layout shared by the v2 host section and both v3 fabric
    lists (byte-compatible with the original v2 host encoding)."""
    parts: list[Any] = [struct.pack("<I", len(names))]
    for n in names:
        nb = str(n).encode()
        if len(nb) > 0xFFFF:
            raise ValueError(f"{what} name exceeds 65535 bytes")
        parts.append(struct.pack("<H", len(nb)))
        parts.append(nb)
    return parts


def _validate_placement(p: EvidencePacket) -> None:
    """The placement alignment contract, enforced on encode: fabric
    tiers hang off the tier below them, per rank."""
    if p.switches and not p.hosts:
        raise ValueError("switches declared without hosts")
    if p.switches and len(p.switches) != len(p.hosts):
        raise ValueError(
            f"switches must align with hosts: {len(p.switches)} != "
            f"{len(p.hosts)}"
        )
    if p.pods and not p.switches:
        raise ValueError("pods declared without switches")
    if p.pods and len(p.pods) != len(p.hosts):
        raise ValueError(
            f"pods must align with hosts: {len(p.pods)} != {len(p.hosts)}"
        )


def encode_packet(
    p: EvidencePacket, *, compress: str = "none", wire: str = "sfp2"
) -> bytes:
    """Serialize a packet.

    `compress="int8"` ships the window matrix as per-stage symmetric int8
    (8x smaller payloads, codec shared with the gradient path in
    `repro.distributed.compression`); `"int8.delta"` additionally
    step-deltas and zigzag-varints the quantized stream.  `wire="sfp1"`
    emits the legacy framing (back-compat emitters; no `"int8.delta"`,
    and no placement sections — a packet's declared `hosts` /
    `switches` / `pods` only travel on SFP2, where they promote the
    frame to version 2 / 3).
    """
    if compress not in _COMPRESSIONS:
        raise ValueError(f"unknown compression {compress!r}")
    if wire == "sfp1":
        return _encode_sfp1(p, compress)
    if wire != "sfp2":
        raise ValueError(f"unknown wire format {wire!r}")

    header = _header_dict(p, present_ranks=False)
    payload = None
    if p.window is not None:
        meta_d, payload = _window_payload(p, compress)
        header["window"] = meta_d
    head = json.dumps(header, default=list).encode()
    ranks = np.asarray(p.present_ranks, np.dtype("<u4"))
    flags = _FLAG_WINDOW if payload is not None else 0
    # the LOWEST version that carries the declared placement: hosts
    # promote the frame to v2, fabric tiers (switches/pods) to v3 —
    # hostless packets stay byte-identical v1 and host-only packets
    # byte-identical v2 (pre-fabric decoders keep accepting them
    # unchanged; goldens pin all three).
    _validate_placement(p)
    version = _SFP2_VERSION
    if p.hosts:
        version = (
            _SFP2_VERSION_FABRIC if p.switches else _SFP2_VERSION_HOSTS
        )
    parts: list[Any] = [
        struct.pack("<4sBBI", _MAGIC2, version, flags, len(head)),
        head,
        struct.pack("<I", ranks.size),
        ranks.tobytes(),
    ]
    if p.hosts:
        parts.extend(_pack_names(p.hosts, "host"))
    if p.switches:
        parts.extend(_pack_names(p.switches, "switch"))
        parts.extend(_pack_names(p.pods, "pod"))
    if payload is not None:
        parts.append(struct.pack("<II", len(payload), zlib.adler32(payload)))
        parts.append(payload)
    return b"".join(parts)


def _encode_sfp1(p: EvidencePacket, compress: str) -> bytes:
    """Legacy SFP1 framing, byte-identical to the pre-SFP2 encoder (the
    golden fixtures assert this) — minus its `dataclasses.asdict` window
    deep-copy."""
    if compress == "int8.delta":
        raise ValueError("int8.delta requires the SFP2 wire format")
    head = json.dumps(_header_dict(p, present_ranks=True), default=list).encode()
    parts: list[Any] = [_MAGIC, len(head).to_bytes(4, "little"), head]
    if p.window is not None:
        meta_d, payload = _window_payload(p, compress)
        meta = json.dumps(meta_d, default=list).encode()
        parts.append(len(meta).to_bytes(4, "little"))
        parts.append(meta)
        parts.append(hashlib.sha256(payload).digest()[:8])
        parts.append(payload)
    else:
        parts.append((0).to_bytes(4, "little"))
    return b"".join(parts)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _need(data, off: int, n: int, what: str) -> int:
    """Strict-bounds guard: the next `n` bytes must exist."""
    end = off + n
    if n < 0 or end > len(data):
        raise ValueError(f"truncated packet: {what}")
    return end


def _read_names(
    mv: memoryview, off: int, what: str
) -> tuple[list[str], int]:
    """Decode one binary name-list section (see `_pack_names`); returns
    (names, new offset).  Bounds-checked per field like every section."""
    end = _need(mv, off, 4, f"{what} count")
    (count,) = struct.unpack_from("<I", mv, off)
    off = end
    if count > 1 << 24:
        raise ValueError(f"{what} count exceeds size cap")
    names: list[str] = []
    for _ in range(count):
        end = _need(mv, off, 2, f"{what}-name length")
        (nl,) = struct.unpack_from("<H", mv, off)
        off = _need(mv, end, nl, f"{what} name")
        names.append(str(mv[end:off], "utf-8"))
    return names, off


def _finish_header(header: Any, window: np.ndarray | None) -> EvidencePacket:
    if not isinstance(header, dict):
        raise ValueError("packet header is not an object")
    header.setdefault("present_ranks", [])
    header.setdefault("exposed_total", -1.0)
    header.setdefault("sync_stages", [])
    header.setdefault("first_step", -1)
    header.setdefault("hosts", [])
    header.setdefault("switches", [])
    header.setdefault("pods", [])
    try:
        for key in (
            "stages",
            "labels",
            "routing_stages",
            "shares",
            "gains",
            "co_critical_stages",
            "downgrade_reasons",
            "present_ranks",
            "sync_stages",
            "hosts",
            "switches",
            "pods",
        ):
            header[key] = tuple(header[key])
        return EvidencePacket(window=window, **header)
    except (KeyError, TypeError) as e:
        # missing / extra / non-iterable header fields: the decode
        # contract is ValueError on ANY malformed input, never a leaked
        # KeyError/TypeError
        raise ValueError(f"invalid packet header: {e!r}") from e


def decode_packet(data: bytes) -> EvidencePacket:
    """Decode either wire framing (dispatch on magic).  Every declared
    length is validated against the buffer before slicing and trailing
    bytes are rejected; malformed input raises ValueError (the fleet
    ingest counts-and-drops, never raises)."""
    if len(data) < 4:
        raise ValueError("not a StageFrontier packet")
    magic = bytes(data[:4])
    if magic == _MAGIC2:
        return _decode_sfp2(data)
    if magic == _MAGIC:
        return _decode_sfp1(data)
    raise ValueError("not a StageFrontier packet")


def _decode_sfp2(data: bytes) -> EvidencePacket:
    mv = memoryview(data)
    off = _need(mv, 0, 10, "fixed header")
    _, version, flags, hlen = struct.unpack_from("<4sBBI", mv, 0)
    if version not in (
        _SFP2_VERSION, _SFP2_VERSION_HOSTS, _SFP2_VERSION_FABRIC
    ):
        raise ValueError(f"unsupported SFP2 wire version {version}")
    end = _need(mv, off, hlen, "header")
    header = json.loads(str(mv[off:end], "utf-8"))
    off = end

    end = _need(mv, off, 4, "present-rank count")
    (nranks,) = struct.unpack_from("<I", mv, off)
    off = _need(mv, end, 4 * nranks, "present ranks")
    if not isinstance(header, dict) or "present_ranks" in header:
        raise ValueError("invalid packet header")
    header["present_ranks"] = (
        np.frombuffer(mv[end:off], np.dtype("<u4")).tolist() if nranks else []
    )

    # the binary v2/v3 sections are the ONLY source of placement ids: a
    # JSON header claiming any of the keys is malformed on EVERY route
    # (a v1 frame must not smuggle a placement past the sections' rules).
    if "hosts" in header or "switches" in header or "pods" in header:
        raise ValueError("invalid packet header")
    if version >= _SFP2_VERSION_HOSTS:
        hosts, off = _read_names(mv, off, "host")
        header["hosts"] = hosts
    if version >= _SFP2_VERSION_FABRIC:
        switches, off = _read_names(mv, off, "switch")
        pods, off = _read_names(mv, off, "pod")
        # the alignment contract the encoder enforces, re-checked on the
        # wire: each fabric list is per-rank (aligned with hosts) or
        # absent, and pods hang off switches.
        if switches and len(switches) != len(header["hosts"]):
            raise ValueError("switch section does not align with hosts")
        if pods and (not switches or len(pods) != len(header["hosts"])):
            raise ValueError("pod section does not align with switches")
        header["switches"] = switches
        header["pods"] = pods

    window = None
    meta = header.pop("window", None)
    if flags & _FLAG_WINDOW:
        if meta is None:
            raise ValueError("window flag set but header carries no meta")
        end = _need(mv, off, 8, "window section lengths")
        plen, checksum = struct.unpack_from("<II", mv, off)
        off = end
        end = _need(mv, off, plen, "window payload")
        payload = mv[off:end]
        off = end
        if zlib.adler32(payload) != checksum:
            raise ValueError("packet payload hash mismatch")
        window = _decode_window(payload, meta)
    elif meta is not None:
        raise ValueError("header carries window meta but no payload")
    if off != len(mv):
        raise ValueError("trailing bytes after packet")
    return _finish_header(header, window)


def _decode_sfp1(data: bytes) -> EvidencePacket:
    """Legacy route: identical results for every valid SFP1 packet, but
    with the same strict bounds as SFP2 (declared lengths checked before
    slicing; a compact packet followed by trailing garbage is rejected —
    the old decoder silently accepted both)."""
    mv = memoryview(data)
    off = _need(mv, 4, 4, "header length")
    hlen = int.from_bytes(mv[4:off], "little")
    end = _need(mv, off, hlen, "header")
    header = json.loads(bytes(mv[off:end]))
    off = end
    if isinstance(header, dict) and (
        "hosts" in header or "switches" in header or "pods" in header
    ):
        # SFP1 never carried a placement; only the SFP2 v2/v3 binary
        # sections may declare one (see _decode_sfp2)
        raise ValueError("invalid packet header")
    end = _need(mv, off, 4, "meta length")
    mlen = int.from_bytes(mv[off:end], "little")
    off = end
    window = None
    if mlen:
        end = _need(mv, off, mlen, "window meta")
        meta = json.loads(bytes(mv[off:end]))
        off = _need(mv, end, 8, "payload hash")
        digest = mv[end:off]
        # SFP1 carries no payload length: the payload is the buffer tail,
        # so its size is validated against the declared shape instead.
        payload = mv[off:]
        if hashlib.sha256(payload).digest()[:8] != digest:
            raise ValueError("packet payload hash mismatch")
        window = _decode_window(payload, meta)
    elif off != len(mv):
        raise ValueError("trailing bytes after packet")
    return _finish_header(header, window)
