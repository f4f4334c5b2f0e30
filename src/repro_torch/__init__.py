"""PyTorch + CUDA port of the Lustre simulator (`repro`).

It mirrors the layout of `repro` and imports torch and numpy, never JAX
and nothing of `repro`: the simulator modules it needs are its own
copies, and its kernels are hand-written CUDA for Hopper (sm_90a).
Entry points: `repro_torch.core.LustreCluster(..., device="cuda")` and
`repro_torch.fsio.LustreClient`.
"""
