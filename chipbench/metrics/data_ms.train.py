"""The mean time a training step waits for its batch: the benchmark's
span around `Trainer._batch` (the TokenPipeline's striped reads, the
labels, the copy to the card), in milliseconds."""


def read(run):
    spans = [u["data_s"] for u in run.units if "data_s" in u]
    return 1e3 * sum(spans) / len(spans) if spans else None
