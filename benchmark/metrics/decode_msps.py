"""decode_msps: new samples decoded (every `*<hex>;` line produced) over
the wall time of the whole timed call, its drain included, in Msamples/s."""


def read(run):
    samples = getattr(run, "samples", None)
    if not samples or run.window_s <= 0:
        return None
    return samples / run.window_s / 1e6
