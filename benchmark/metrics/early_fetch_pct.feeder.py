"""early_fetch_pct.feeder: the share of the window's groups, in percent,
that the pipeline fetched because no next input was ready (the program's
mark pipeline.fetch.early): the groups that did not wait behind the
dispatch depth."""

from benchmark import early_fetch


def read(run):
    return early_fetch.early_fetch_pct(run)
