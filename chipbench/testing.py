"""A small checkout for the CPU tests: a `BENCHMARK.json` and a
`chipbench/` folder of files only (configurations at a size the CPU
holds, traffic, limits), beside this package's metric readers."""
from __future__ import annotations

import json
import pathlib
import shutil
import time

HERE = pathlib.Path(__file__).resolve().parent

SMALL = {
    "phi35moe": {"hidden_size": 64, "intermediate_size": 96,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "num_key_value_heads": 2, "num_local_experts": 4,
                 "vocab_size": 256},
    "zamba2": {"hidden_size": 64, "num_hidden_layers": 7,
               "num_attention_heads": 4, "num_key_value_heads": 4,
               "kv_channels": 16, "ffn_hidden_size": 96,
               "mamba_d_state": 16, "mamba_headdim": 16,
               "vocab_size": 256, "hybrid_layer_ids": [6],
               "chunk_size": 64},
    "phi35moe_train": {"hidden_size": 64, "intermediate_size": 96,
                       "num_attention_heads": 4, "num_key_value_heads": 2,
                       "num_local_experts": 4, "vocab_size": 256,
                       "run": {"param_dtype": "float32",
                               "compute_dtype": "float32",
                               "attn_impl": "auto", "remat": "full"}},
    "phi35moe_shard": {"hidden_size": 64, "intermediate_size": 96,
                       "num_attention_heads": 4, "num_key_value_heads": 2,
                       "num_local_experts": 4, "vocab_size": 256},
}
TRAFFIC = {
    "chat": {"round": 8, "sample": 3,
             "lengths": {"dist": "lognormal", "median": 200, "sigma": 1.0,
                         "min": 128, "max": 512, "multiple": 128}},
    "docs": {"round": 4, "sample": 2,
             "lengths": {"dist": "choice", "values": [128, 256]}},
    "ckpt_cycle": {"stripe_size": 4096},
    "train_4k": {"batch": 4, "seq_len": 64, "microbatches": 2,
                 "dataset_seqs": 32},
}


def small_checkout(dest: pathlib.Path, cells=None, **override) -> pathlib.Path:
    """`dest` made a checkout of the benchmark's files at CPU sizes,
    holding `cells` (all by default).  Returns its BENCHMARK.json."""
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    if cells is not None:
        spec["workloads"] = [w for w in spec["workloads"]
                             if w["name"] in cells]
    home = dest / HERE.name
    for sub in ("configs", "traffic", "limits"):
        (home / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", home / "metrics", dirs_exist_ok=True)
    for c in spec["configs"]:
        cfg = json.loads((HERE.parent / c["file"]).read_text())
        cfg.update(SMALL.get(c["name"], {}))
        cfg.update(override.get(c["name"], {}))
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        t = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t.update(TRAFFIC.get(w["traffic"], {}))
        (home / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        shutil.copy(HERE / "limits" / f"{w['name']}.json",
                    home / "limits" / f"{w['name']}.json")
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest / "BENCHMARK.json"


SEED = 2**31 + 4099
F32 = {"run": {"param_dtype": "float32", "compute_dtype": "float32",
               "attn_impl": "flash"}}


def run(bench, name, job=None, seconds=0.3, trace=False):
    """One run of cell `name` of the checkout `bench` on the CPU; `job`
    makes the job that replaces the cell's own."""
    from chipbench.cell import execute, load_cell
    cell = load_cell(name, bench)
    return execute(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                   job=job(cell) if job else None)


def few_threads():
    """A fixture body: two intra-op threads for the test (the suite's
    workers share the machine's cores), the old count restored after."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
