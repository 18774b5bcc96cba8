"""ingest.us_per_buffer: microseconds a buffer of the archive's ingest on
the reader thread (the program's spans pipeline.ingest.source, .stack and
.upload: the read and framing, the group's stack, the pageable upload)."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, spans.INGEST, 1e6, reader_thread=True)
