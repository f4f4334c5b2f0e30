"""The plain reference: the same semantics as the program, written out in
plain PyTorch and NumPy from the published descriptions (and the port's
stated departures, which each configuration file lists), independent of
the program.  Nothing here imports `jax`, the JAX package or anything of
`repro_torch`; it takes the weights and inputs that the benchmark made,
never what the program made from them.

`F32` computes in float32 with TF32 off (the reference); `FP8` is the
control, the same computation with every matrix product's operands
rounded to float8 e4m3 under a scale per tensor, the precision below the
configurations' bfloat16 (in training, gradients pass the rounding
unchanged and the backward products take the rounded operands).
"""
from __future__ import annotations

import torch


class F32:
    name = "float32"

    @staticmethod
    def act(t: torch.Tensor) -> torch.Tensor:
        return t.float()

    @classmethod
    def mm(cls, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return cls.act(x) @ cls.act(w)


class FP8(F32):
    name = "float8_e4m3fn"

    @staticmethod
    def act(t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if t.numel() == 0:
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (q - t.detach())    # the gradient passes straight on


def flat(tree, prefix=()):
    """(dotted path, leaf) of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), tree


def no_tf32() -> None:
    """Float32 products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def token_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each position's ||got - want|| / ||want|| over its other
    dimensions (the first dimension is the position), in float64."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-300)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over all elements, in float64."""
    want = want.double()
    diff = got.double() - want
    return float(diff.norm() / want.norm().clamp_min(1e-300))
