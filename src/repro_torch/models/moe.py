"""Mixture-of-Experts feed-forward (top-k router, capacity-based dispatch).

Einsum dispatch in token groups: tokens are processed in groups of
``cfg.moe_group`` so the [tokens, experts, capacity] dispatch tensor stays
small; the reference's scan over groups is a Python loop here.  Expert
weights are stacked [E, ...]; the router stays f32 whatever the model's
parameter dtype, as in the reference.

Routing follows the reference exactly:
- the top k experts of each token by a stable descending sort, so equal
  gates put the lower expert first, as `jax.lax.top_k` does (a padded
  token's gates are all equal);
- each expert's slots are handed out by a cumulative sum, slot 0 of
  every token before slot 1, the counts carried across slots; an
  assignment past the capacity is dropped, not rerouted;
- dispatch and combine are rounded to the compute dtype before their
  einsums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init

__all__ = ["MoE", "apply_moe", "capacity", "dropped", "moe_axes", "top_k"]


class MoE(nn.Module):
    """The expert block's parameters (the reference's `init_moe` names);
    calling it applies `apply_moe`."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.router = nn.Parameter(dense_init(generator, (d, e), torch.float32, device))
        self.wi_gate = nn.Parameter(dense_init(generator, (e, d, f), dtype, device))
        self.wi_up = nn.Parameter(dense_init(generator, (e, d, f), dtype, device))
        self.wo = nn.Parameter(dense_init(generator, (e, f, d), dtype, device))

    def forward(self, x: torch.Tensor, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
        return apply_moe(self, x, self.cfg, tp)


def moe_axes() -> dict:
    """Logical axes of `MoE`'s parameters.  Expert weights are 2D-sharded:
    experts over `model` (EP), the expert hidden dim over `data`."""
    return {
        "router": ("embed", None),
        "wi_gate": ("expert", "embed", "expert_mlp"),
        "wi_up": ("expert", "embed", "expert_mlp"),
        "wo": ("expert", "expert_mlp", "embed"),
    }


def capacity(tokens: int, cfg) -> int:
    """Slots per expert in a group of `tokens` (the reference's `_capacity`)."""
    cap = int(cfg.top_k * tokens * cfg.capacity_factor / cfg.n_experts)
    return max(cap, cfg.top_k)


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates of each row and their experts, equal gates
    lower expert first (`jax.lax.top_k`'s order; `torch.topk` promises
    none)."""
    probs, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return probs[..., :k], idx[..., :k]


def _group(p: MoE, xg: torch.Tensor, cfg, cap: int, tp=None):
    """One dispatch group. xg: [g, D] -> (y [g, D], aux []).

    With `tp` and the experts split over the model axis, the router and
    the routing stay whole (the same on every rank); the dispatch and the
    expert products run on this rank's experts, and the combine, a
    contraction over the experts, is a partial sum all-reduced."""
    g = xg.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gates = torch.softmax(xg.float() @ p.router, dim=-1)           # [g, E]
    probs, idx = top_k(gates, k)                                    # [g, k]
    slots = torch.arange(cap, device=xg.device)
    counts = torch.zeros(e, dtype=torch.float32, device=xg.device)
    dispatch = torch.zeros((g, e, cap), dtype=torch.float32, device=xg.device)
    combine = torch.zeros((g, e, cap), dtype=torch.float32, device=xg.device)
    for slot in range(k):
        oh = F.one_hot(idx[:, slot], e).float()                     # [g, E]
        pos = torch.cumsum(oh, dim=0) - oh + counts                 # [g, E]
        counts = counts + oh.sum(dim=0)
        within = (pos < cap) & (oh > 0)
        # a position past the capacity has no slot (jax's one_hot: zeros)
        pos_oh = (pos[..., None] == slots).float()                  # [g, E, cap]
        disp = torch.where(within[..., None], oh[..., None] * pos_oh, 0.0)
        dispatch = dispatch + disp
        combine = combine + disp * probs[:, slot][:, None, None]
    cd = xg.dtype
    split = tp is not None and tp.dim(p.wo) == 0
    xin = xg
    if split:  # this rank's experts
        local = p.wo.shape[0]
        dispatch = dispatch[:, tp.start(local):tp.start(local) + local]
        combine = tp.split(combine, 1)
        xin = tp.copy(xg)
    xe = torch.einsum("tec,td->ecd", dispatch.to(cd), xin)          # [E,cap,D]
    hg = F.silu(torch.einsum("ecd,edf->ecf", xe, p.wi_gate))
    hu = torch.einsum("ecd,edf->ecf", xe, p.wi_up)
    ye = torch.einsum("ecf,efd->ecd", hg * hu, p.wo)                # [E,cap,D]
    y = torch.einsum("tec,ecd->td", combine.to(cd), ye)             # [g, D]
    if split:
        y = tp.reduce(y)
    # load-balance aux: mean gate prob per expert x fraction routed
    route_frac = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = (gates.mean(dim=0) * route_frac).sum() * e
    return y, aux


def _groups(x: torch.Tensor, cfg) -> tuple[torch.Tensor, int]:
    """x: [B, S, D] -> (zero-padded groups [n_groups, g, D], cap)."""
    b, s, d = x.shape
    t_total = b * s
    g = min(cfg.moe_group, t_total)
    n_groups = (t_total + g - 1) // g
    xt = F.pad(x.reshape(t_total, d), (0, 0, 0, n_groups * g - t_total))
    return xt.reshape(n_groups, g, d), capacity(g, cfg)


def dropped(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """The (token, slot) assignments `apply_moe(p, x, cfg)` drops at
    capacity, summed over its groups (a tensor on x's device): an expert
    handed n assignments in a group keeps the first `cap`."""
    xg, cap = _groups(x, cfg)
    gates = torch.softmax(xg.float() @ p.router, dim=-1)            # [G, g, E]
    idx = top_k(gates, cfg.top_k)[1].reshape(xg.shape[0], -1)
    per_expert = F.one_hot(idx, cfg.n_experts).sum(dim=1)           # [G, E]
    return (per_expert - cap).clamp_min(0).sum()


def _gathers(p: MoE, tokens: int, cfg, tp) -> bool:
    """Whether the block gathers its tokens over the batch axes: where
    this rank's tokens are no whole number of the global array's groups,
    or an expert weight is split over a batch axis (a serve step)."""
    if tp is None or tp.batch_size == 1:
        return False
    return (tp.batch_dim(p.wo) is not None
            or tokens % min(cfg.moe_group, tokens * tp.batch_size) != 0)


def apply_moe(p: MoE, x: torch.Tensor, cfg, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux_loss []).

    aux_loss is the standard load-balancing loss (mean gate fraction x
    mean routed fraction x E), averaged over the groups.  When B*S is no
    multiple of the group size the last group is padded with zero rows,
    which take slots and enter the aux loss, as in the reference.  `tp`:
    expert parallelism over the model axis (`_group`).

    The reference groups the global token array.  Where the batch is
    split over ranks (``tp.batch``) and this rank's tokens are no whole
    number of those groups, or the experts' hidden dim is split over a
    batch axis, the block gathers its input over the batch axes, routes
    the global groups (the same on every rank, so the aux is the global
    one), computes on this rank's expert shards and keeps this rank's
    rows, reduce-scattered over the axes the hidden dim is split on.
    """
    b, s, d = x.shape
    gather = _gathers(p, b * s, cfg, tp)
    if gather:
        x = tp.gather_batch(x, 0)
    rows = x.shape[0]
    xg, cap = _groups(x, cfg)
    outs = [_group(p, group, cfg, cap, tp) for group in xg]
    y = torch.cat([o[0] for o in outs])[:rows * s].reshape(rows, s, d)
    aux = torch.stack([o[1] for o in outs]).mean()
    if gather:
        y = tp.scatter_batch(y, 0, p.wo)
    return y, aux
