"""graph_replay_pct.archive: the share of the window's groups, in percent,
that the pipeline dispatched by replaying its dispatch shape's CUDA graph
(the program's mark pipeline.graph.replay): the groups whose ~550 kernels
the host did not issue one by one."""

from benchmark import graph_replay


def read(run):
    return graph_replay.graph_replay_pct(run)
