"""Parameter and trainer-state bridge between the two packages.

Both keep parameters as a nested dict keyed like `param_defs`, with the
layers stacked on a leading axis.  The reference's tree, after
`np.asarray` on each leaf, is a nested dict of numpy arrays;
`from_numpy` / `to_numpy` carry it to the port's tensors and back.
bfloat16 arrays (numpy has no such type of its own) cross as float32,
which holds every bfloat16 value exactly.  `state_from_numpy` /
`state_to_numpy` carry a whole trainer state, {"params": ..., "opt":
{"step", "m", "v"}}, with the step as an int32 scalar.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.layers import tree_map


def from_numpy(tree, device="cuda", dtype=torch.float32):
    """Nested dict of numpy arrays -> nested dict of `dtype` tensors on
    `device`."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(dev, dtype)   # a copy

    return tree_map(leaf, tree)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (bfloat16 as
    float32)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)


def state_from_numpy(state, device="cuda"):
    """{"params", "opt": {"step", "m", "v"}} of numpy arrays -> (params,
    opt_state) of tensors on `device`: params and moments in float32, the
    step an int32 0-d tensor."""
    opt = state["opt"]
    step = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                        device=resolve_device(device))
    return (from_numpy(state["params"], device),
            {"step": step, "m": from_numpy(opt["m"], device),
             "v": from_numpy(opt["v"], device)})


def state_to_numpy(params, opt_state):
    """(params, opt_state) of tensors -> {"params", "opt": {"step", "m",
    "v"}} of numpy arrays, the step an int32 0-d array."""
    return {"params": to_numpy(params),
            "opt": {"step": np.asarray(int(opt_state["step"]), np.int32),
                    "m": to_numpy(opt_state["m"]),
                    "v": to_numpy(opt_state["v"])}}
