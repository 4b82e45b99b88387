"""Prefetch-budget model (paper §4.1 + Appendix C) and calibration.

Appendix C shows the optimum lies at one of two points:
  case 1:  b_p* = B_link · t_LLM        (prefetch exactly through the
           pre-retrieval generation window — optimal whenever extra
           transfer time outweighs the marginal miss-rate reduction)
  case 2:  the stationary point of  b_p/B + r_miss(b_p)·nprobe·t_cc,
           valid only if it exceeds case 1 (rare on real link speeds).

We implement both: case 1 analytically, case 2 numerically over an
empirical miss-rate curve, and pick per Appendix C's rule. ``t̄_LLM`` is
calibrated from traces with a roofline decode-latency model (the paper
profiles 64 NQ samples; we do the same over synthetic traces).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link
    host_link_bw: float        # host<->chip bytes/s (the paper's "PCIe")
    hbm_bytes: float           # HBM capacity per chip
    # Effective per-query CPU scan bandwidth. 5 GB/s reproduces the
    # paper's Fig. 4/5 regime: 15 MB clusters -> ~3 ms per cluster, so
    # nprobe=256 CPU retrieval lands at ~0.8 s and makes retrieval 40-60%
    # of end-to-end latency, as measured there.
    host_mem_bw: float = 5e9
    host_search_overhead: float = 50e-6   # per-cluster dispatch overhead


TPU_V5E = HardwareProfile(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    host_link_bw=32e9,
    hbm_bytes=16e9,
)

# paper hardware (for paper-faithful modeled numbers)
RTX4090 = HardwareProfile("rtx4090", 165e12, 1008e9, 0.0, 32e9, 24e9)
H100 = HardwareProfile("h100", 989e12, 3350e9, 0.0, 64e9, 80e9)


def host_cluster_search_seconds(cluster_bytes: float, hw: HardwareProfile,
                                ) -> float:
    """CPU per-cluster similarity-search cost: memory-bound dot products
    over the cluster's vectors + fixed dispatch overhead. At the paper's
    scale (61 GB / 4096 clusters ≈ 15 MB/cluster) this lands at ~0.8 ms,
    matching the Fig. 4/5 regime where nprobe=256 CPU retrieval takes
    hundreds of ms and dominates end-to-end latency."""
    return cluster_bytes / hw.host_mem_bw + hw.host_search_overhead


# ---------------------------------------------------------------------------
# Decode latency model (memory-bound roofline; used for t̄_LLM calibration)
# ---------------------------------------------------------------------------


def decode_step_seconds(cfg: ArchConfig, hw: HardwareProfile, *,
                        batch: int, kv_len: int, chips: int = 1) -> float:
    """Per-token decode latency: max(weight+KV HBM reads, compute)."""
    act_params = cfg.active_param_count()
    weight_bytes = act_params * 2                         # bf16
    kv_bytes_per_seq = _kv_bytes_per_token(cfg) * kv_len
    mem = (weight_bytes + batch * kv_bytes_per_seq) / (hw.hbm_bw * chips)
    flops = 2 * act_params * batch + 2 * batch * _kv_flops_per_token(cfg, kv_len)
    comp = flops / (hw.peak_flops * chips)
    return max(mem, comp)


def _kv_bytes_per_token(cfg: ArchConfig) -> int:
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return 0                                           # O(1) state
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    if cfg.shared_attn_every:
        n_shared = cfg.num_layers // cfg.shared_attn_every
        return n_shared * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    return cfg.num_layers * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2


def _kv_flops_per_token(cfg: ArchConfig, kv_len: int) -> int:
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        K = cfg.ssm.head_dim
        return cfg.num_layers * (cfg.d_model // K) * K * K * 2
    hd = cfg.resolved_head_dim
    L = (cfg.num_layers // cfg.shared_attn_every
         if cfg.shared_attn_every else cfg.num_layers)
    return L * cfg.num_heads * hd * kv_len * 2


def generation_window_seconds(cfg: ArchConfig, hw: HardwareProfile, *,
                              gen_tokens: Sequence[int], batch: int,
                              kv_len: int = 1024, chips: int = 1) -> float:
    """t̄_LLM: average pre-retrieval generation time over a trace sample."""
    per_tok = decode_step_seconds(cfg, hw, batch=batch, kv_len=kv_len,
                                  chips=chips)
    return float(np.mean(np.asarray(gen_tokens))) * per_tok


# ---------------------------------------------------------------------------
# Appendix C optimum
# ---------------------------------------------------------------------------


def case1_budget(t_llm: float, link_bw: float) -> int:
    return int(link_bw * t_llm)


def case2_budget(miss_rate_fn: Callable[[float], float], *,
                 link_bw: float, nprobe: int, t_cc: float,
                 b_max: float, n_grid: int = 256) -> Optional[int]:
    """Numeric stationary point of t1+t2 = b/B + r(b)·nprobe·t_cc on (0,b_max].

    Returns None when no interior minimum beats the boundary (the common
    case on modern links, per Appendix C).
    """
    bs = np.linspace(b_max / n_grid, b_max, n_grid)
    total = bs / link_bw + np.array([miss_rate_fn(b) for b in bs]) * nprobe * t_cc
    i = int(np.argmin(total))
    if 0 < i < n_grid - 1:
        return int(bs[i])
    return None


def optimal_budget(cfg: ArchConfig, hw: HardwareProfile, *,
                   gen_tokens: Sequence[int], batch: int,
                   miss_rate_fn: Optional[Callable[[float], float]] = None,
                   nprobe: int = 256, t_cc: float = 120e-6,
                   hbm_headroom_bytes: Optional[float] = None,
                   kv_len: int = 1024, chips: int = 1) -> int:
    """Full §4.1 policy: b* = B·t̄_LLM, optionally improved by case 2,
    clamped to the HBM headroom left after the model + KV cache."""
    t_llm = generation_window_seconds(cfg, hw, gen_tokens=gen_tokens,
                                      batch=batch, kv_len=kv_len, chips=chips)
    b = case1_budget(t_llm, hw.host_link_bw)
    if miss_rate_fn is not None:
        c2 = case2_budget(miss_rate_fn, link_bw=hw.host_link_bw,
                          nprobe=nprobe, t_cc=t_cc, b_max=4 * max(b, 1))
        if c2 is not None and c2 > b:
            b = c2
    if hbm_headroom_bytes is None:
        weight_bytes = cfg.active_param_count() * 2 / max(chips, 1)
        kv = _kv_bytes_per_token(cfg) * kv_len * batch / max(chips, 1)
        hbm_headroom_bytes = max(hw.hbm_bytes - weight_bytes - kv, 0) * 0.8
    return int(min(b, hbm_headroom_bytes))


def empirical_miss_curve(budgets: Sequence[float], hit_rates: Sequence[float],
                         ) -> Callable[[float], float]:
    """Interpolated r_miss(b) from profiled (budget, hit-rate) pairs."""
    bs = np.asarray(budgets, float)
    ms = 1.0 - np.asarray(hit_rates, float)
    order = np.argsort(bs)
    bs, ms = bs[order], ms[order]

    def fn(b: float) -> float:
        return float(np.interp(b, bs, ms))

    return fn
