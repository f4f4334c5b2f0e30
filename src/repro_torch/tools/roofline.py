"""Three-term roofline of a dry-run cell: `repro.tools.roofline` with the
H100's denominators (`launch/mesh.py`).

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = traffic_bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

The counter (`tools/hlo_cost.py`) records each device's local ops, so
per-device / per-device-rate is the spec's global / (devices x rate).
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.tools.hlo_cost import CostReport


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float           # 6*N*D (global, per step)
    hlo_flops_global: float
    useful_ratio: float          # MODEL_FLOPS / counted FLOPs, global
    bound_s: float               # max of the three terms
    mfu_bound: float             # model_flops / (chips*peak) / bound_s

    def as_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg, rc) -> float:
    """6*N*D for train, 2*N*D for prefill, 2*N_active*B per decoded token.

    N excludes embedding gathers (standard convention); MoE uses active
    params. Attention flops excluded (convention)."""
    n_act = cfg.n_active_params
    if rc.kind == "train":
        return 6.0 * n_act * rc.global_batch * rc.seq_len
    if rc.kind == "prefill":
        return 2.0 * n_act * rc.global_batch * rc.seq_len
    return 2.0 * n_act * rc.global_batch  # decode: one token per sequence


def mfu(cfg, rc, seconds: float, n_chips: int = 1) -> float:
    """Model FLOPs utilisation of a measured step: model_flops over the
    devices' bf16 peak times the step's seconds."""
    return model_flops(cfg, rc) / (n_chips * PEAK_FLOPS_BF16 * seconds)


def compute(report: CostReport, cfg, rc, n_chips: int) -> Roofline:
    c = report.flops / PEAK_FLOPS_BF16
    m = report.traffic_bytes / HBM_BW
    x = report.collective_bytes / LINK_BW
    terms = {"compute": c, "memory": m, "collective": x}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, rc)
    hlo_global = report.flops * n_chips
    bound = max(c, m, x)
    mfu_b = (mf / (n_chips * PEAK_FLOPS_BF16)) / bound if bound > 0 else 0.0
    return Roofline(c, m, x, dominant, mf, hlo_global,
                    mf / hlo_global if hlo_global else 0.0, bound, mfu_b)
