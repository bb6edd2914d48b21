"""Roofline terms from the counts of one eager call of a step.

Three terms per (arch x shape x mesh), NVIDIA H100 SXM constants:

    compute    = FLOPs_per_device / peak_bf16_flops
    memory     = bytes_per_device / hbm_bandwidth
    collective = collective_bytes_per_device / link_bandwidth

Sources: `OpCounter`, a `TorchDispatchMode` over the aten ops the step
dispatches on this rank (the dry run runs it under `FakeTensorMode`, so
nothing is allocated):
- flops: `torch.utils.flop_counter`'s formulas (matmuls, convolutions,
  attention), as `FlopCounterMode` counts them; elementwise work is not
  counted.  An op on a DTensor is counted on its local shard, not on its
  global shape, so every figure is per device.
- bytes: each op's operand bytes (each distinct tensor once) plus its
  result bytes; a view moves nothing and is skipped.  Eager torch runs
  no fusion, so this is what the eager step moves, where XLA's
  `cost_analysis` counts per fusion: the two differ for that reason.
- collective bytes: the RESULT bytes of every functional collective
  (`_c10d_functional`), summed per kind under the reference's convention:
  all-gather, all-reduce (x `AR_FACTOR`), reduce-scatter, all-to-all,
  collective-permute (a point-to-point receive; its send is not counted,
  as the reference skips an async op's ``-done``); ``wait_tensor`` is
  not a collective.

The reference's scan correction is not ported: XLA counts a while-loop
body once, so the reference lowers 1- and 2-layer unrolled steps and
extrapolates (`delta_extrapolate`).  Eager torch dispatches every layer,
attention chunk, microbatch and MoE group, so the full-depth step is
counted directly.  There is no HLO text, so there is no
`collective_bytes(hlo_text)` either.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = [
    "AR_FACTOR",
    "CellCosts",
    "HBM_BW",
    "LINK_BW",
    "OpCounter",
    "PEAK_BF16",
    "RooflineReport",
    "model_flops",
    "roofline",
]

#: dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16 = 989e12
#: HBM3 bandwidth of one H100 SXM (NVIDIA data sheet).
HBM_BW = 3.35e12
#: the link a collective of the production meshes crosses.  Every axis of
#: the (16, 16) and (2, 16, 16) meshes spans more than one 8-GPU HGX H100
#: node, so a collective is bound by the node's network: one ConnectX-7
#: NDR InfiniBand port per GPU, 400 Gb/s = 50e9 B/s.  A collective inside
#: one node would see NVLink's 450 GB/s per direction instead.
LINK_BW = 50e9
#: ring all-reduce moves ~2x the payload per device (reduce-scatter+all-gather).
AR_FACTOR = 2.0

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
#: op name fragment -> kind, first match wins
_KIND_OF = (
    ("all_gather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("irecv", "collective-permute"),
)
#: a wait, and a send (its receive counts the pair)
_NOT_COUNTED = ("wait_tensor", "isend")


def _flat(x, out: list) -> list:
    """The tensors in a nest of lists, tuples and dicts, a DTensor as its
    local shard (pytree's flatten costs more than the ops it counts)."""
    if isinstance(x, torch.Tensor):
        out.append(x._local_tensor if isinstance(x, DTensor) else x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> str | None:
    """The reference's kind of a functional collective ("" for one not
    counted, its own name for one of no kind), None for any other op."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    if name in _NOT_COUNTED:
        return ""
    for fragment, kind in _KIND_OF:
        if fragment in name:
            return kind
    return name


class OpCounter(TorchDispatchMode):
    """Counts what the aten ops dispatched under it cost on this rank:
    `flops`, `bytes_accessed`, collective result bytes and counts by
    kind, and the peak of live storage bytes first seen as an op's
    result (`peak_bytes`; storages passed to `known` beforehand, the
    step's arguments, are not counted).  Storages are tracked by weakref
    finalizers, so the peak follows eager torch's frees."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_by_kind = {k: 0.0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak_bytes = 0
        self._seen: dict[int, int] = {}
        self._ops: dict = {}

    def known(self, tensors) -> None:
        """Mark these tensors' storages as existing before the call."""
        for t in _flat(list(tensors), []):
            self._seen.setdefault(t.untyped_storage()._cdata, 0)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._seen:
            return
        n = storage.nbytes()
        self._seen[key] = n
        self.live += n
        weakref.finalize(storage, self._free, key)

    def _op(self, func):
        """(collective kind, flop formula or None, is a view, has a
        composite decomposition) of an op."""
        info = self._ops.get(func)
        if info is None:
            kind = "" if func.namespace == "prim" else _collective_kind(func)
            flop = flop_registry.get(func._overloadpacket)
            composite = (flop is None and func.namespace == "aten"
                         and torch._C._dispatch_has_kernel_for_dispatch_key(
                             func.name(), "CompositeImplicitAutograd"))
            info = self._ops[func] = (kind, flop, func.is_view, composite)
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, flop, is_view, composite = self._op(func)
        if composite:
            # under inference mode a composite op (matmul, einsum, linear)
            # reaches the mode whole: count the ops it is made of, as
            # autograd's dispatch would have handed them over
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if kind == "":  # `.device` queries, waits, sends: nothing to count
            return out
        results = _flat(out, [])
        if kind is not None:
            b = float(sum(_nbytes(t) for t in results))
            if kind == "all-reduce":
                b *= AR_FACTOR
            self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + b
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        if flop is not None:
            local = lambda x: x._local_tensor if isinstance(x, DTensor) else x
            self.flops += flop(*[local(a) for a in args],
                               **{k: local(v) for k, v in kwargs.items()},
                               out_val=results[0] if len(results) == 1 else results)
        if not is_view:
            operands = {id(t): t for t in _flat((args, kwargs), [])}
            self.bytes_accessed += sum(_nbytes(t) for t in operands.values())
            self.bytes_accessed += sum(_nbytes(t) for t in results)
        for t in results:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live)
        return out


@dataclasses.dataclass
class CellCosts:
    flops: float = 0.0            # per-device
    bytes_accessed: float = 0.0   # per-device
    coll_bytes: float = 0.0       # per-device (weighted, AR_FACTOR applied)
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_counter(counter: OpCounter) -> "CellCosts":
        return CellCosts(
            flops=float(counter.flops),
            bytes_accessed=float(counter.bytes_accessed),
            coll_bytes=float(sum(counter.coll_by_kind.values())),
            coll_by_kind={k: float(v) for k, v in counter.coll_by_kind.items()},
            coll_counts=dict(counter.coll_counts),
        )


@dataclasses.dataclass
class RooflineReport:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    hlo_flops_global: float
    useful_ratio: float            # MODEL_FLOPS / HLO_FLOPs (global)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline(costs: CellCosts, n_chips: int, model_flops_global: float) -> RooflineReport:
    compute_s = costs.flops / PEAK_BF16
    memory_s = costs.bytes_accessed / HBM_BW
    collective_s = costs.coll_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    hlo_global = costs.flops * n_chips
    return RooflineReport(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_global=model_flops_global,
        hlo_flops_global=hlo_global,
        useful_ratio=(model_flops_global / hlo_global) if hlo_global else 0.0,
    )


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (the "useful compute" reference)
# ---------------------------------------------------------------------------


def _matmul_params(cfg) -> tuple[float, float]:
    """(dense-path matmul params per layer, active expert params per layer)."""
    per_layer = 0.0
    active = 0.0
    d = cfg.d_model
    if cfg.family != "ssm":
        per_layer += d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_d_inner
        n = cfg.ssm_state
        per_layer += d * (2 * d_in + 2 * n + cfg.ssm_n_heads) + d_in * d
    if cfg.n_experts:
        expert = 3 * d * cfg.d_ff
        active += cfg.top_k * expert            # routed tokens' compute
        per_layer += d * cfg.n_experts          # router
    elif cfg.d_ff:
        glu = 3 if cfg.act in ("swiglu", "geglu") else 2
        per_layer += glu * d * cfg.d_ff
    return per_layer, active


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs for the cell (global, per step).

    train: 6 * N_active * tokens (fwd+bwd) + causal attention term
    prefill: 2 * N_active * tokens + attention
    decode: per token: 2 * N_active + KV-cache attention reads
    """
    per_layer, active = _matmul_params(cfg)
    n_layer_params = (per_layer + active) * cfg.n_layers
    if cfg.family == "encdec":
        enc_layer = (
            cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
            + cfg.q_dim * cfg.d_model + 2 * cfg.d_model * cfg.d_ff
        )
        n_layer_params += enc_layer * cfg.n_enc_layers
        n_layer_params += (
            cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
            + cfg.q_dim * cfg.d_model
        ) * cfg.n_layers  # cross attention
    head = cfg.d_model * cfg.padded_vocab
    b, s = shape.global_batch, shape.seq_len

    if shape.kind in ("train", "prefill"):
        tokens = b * s
        factor = 6.0 if shape.kind == "train" else 2.0
        flops = factor * tokens * (n_layer_params + head)
        # causal attention: 2 matmuls (scores, pv) over S^2/2 useful pairs
        if cfg.family != "ssm":
            att = 2 * 2 * b * cfg.n_heads * cfg.head_dim * (s * s / 2)
            if cfg.attention == "sliding":
                att = 2 * 2 * b * cfg.n_heads * cfg.head_dim * s * min(s, cfg.window)
            flops += factor / 2 * att  # bwd recomputes ~2x fwd attention
        if cfg.family in ("ssm", "hybrid"):
            # SSD: intra-chunk quadratic + state updates
            q = cfg.ssm_chunk
            h, p, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
            ssd = 2 * b * s * (q * h * p + h * p * n * 2) * cfg.n_layers
            flops += factor / 2 * ssd
        return float(flops)

    # decode: one new token against a seq_len context
    per_tok = 2 * (n_layer_params + head)
    if cfg.family != "ssm":
        ctx = min(s, cfg.window) if cfg.attention == "sliding" else s
        per_tok += 4 * cfg.n_heads * cfg.head_dim * ctx * cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        h, p, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
        per_tok += 6 * h * p * n * cfg.n_layers
    return float(b * per_tok)
