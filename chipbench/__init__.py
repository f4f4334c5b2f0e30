"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one card.

One command runs one cell once (see `run.py`).  Everything that belongs to
one configuration, traffic mix, limit set or per-layer metric is a file of
its own, found by the name that `BENCHMARK.json` gives it:

    configs/<config>.json     the deployment as it is run, with its source
    traffic/<traffic>.json    the parameters of a mix (`gen.py` reads them)
    limits/<workload>.json    the limit of each number that `correct` compares
    metrics/<metric>.py       one reader per per-layer metric (a metric
                              `<name>.<layer>` with no file of its own
                              is read by `metrics/<name>.py`)

`count/` (operations, bytes and peaks), `ref/` (the plain reference) and
the comparison live here too, where the program cannot move them.  Nothing
here imports JAX or the JAX package `repro`; `ref/` imports nothing of
`repro_torch` either.
"""
