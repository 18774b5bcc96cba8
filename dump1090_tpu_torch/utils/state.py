"""Checkpoint / resume: snapshot and restore decoder + tracker state (a copy
of dump1090_tpu/utils/state.py; schema 1, so a snapshot saved by either
package loads in the other).

The device-side form of the ICAO cache and counters is models/state.py
(DecodeState); this module is the host-side JSON checkpoint of the CLI.

The reference has none of this (SURVEY §5: all state is in-memory and lost
on exit).  For long-running / production deployments this module serializes
everything that is not derivable from the input stream:

  * the aircraft table incl. even/odd CPR latches with ms timestamps
  * the receiver auto-reference position (running mean + count)
  * the ICAO recently-seen address cache (addr + unix-second arrays)
  * the stats counters

Format: one JSON document (schema-versioned).  Timestamps are absolute, so
a snapshot restored within the 60 s TTLs resumes seamlessly; an old
snapshot simply ages out, exactly as if the aircraft had gone quiet.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..models.decoder import DecoderStats, IcaoCache
from ..models.tracker import Aircraft, AircraftTracker

SCHEMA = 1


def snapshot(
    tracker: AircraftTracker,
    cache: IcaoCache,
    stats: DecoderStats,
) -> str:
    doc = {
        "schema": SCHEMA,
        "aircraft": [dataclasses.asdict(a) for a in tracker.aircraft],
        "reference": {
            "lat": tracker.ref_lat,
            "lon": tracker.ref_lon,
            "count": tracker.ref_count,
        },
        "icao_cache": {
            "addr": [int(x) for x in cache.addr],
            "ts": [int(x) for x in cache.ts],
        },
        "stats": dataclasses.asdict(stats),
    }
    return json.dumps(doc)


def restore(
    text: str,
    tracker: AircraftTracker,
    cache: IcaoCache,
    stats: DecoderStats,
) -> None:
    doc = json.loads(text)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"unknown state schema {doc.get('schema')!r}")
    tracker.aircraft = [Aircraft(**a) for a in doc["aircraft"]]
    tracker._by_addr = {a.addr: a for a in tracker.aircraft}
    ref = doc["reference"]
    tracker.ref_lat, tracker.ref_lon = ref["lat"], ref["lon"]
    tracker.ref_count = ref["count"]
    cache.addr[:] = np.asarray(doc["icao_cache"]["addr"], dtype=np.uint32)
    cache.ts[:] = np.asarray(doc["icao_cache"]["ts"], dtype=np.int64)
    for k, v in doc["stats"].items():
        setattr(stats, k, v)


def save(path: str, tracker, cache, stats) -> None:
    # atomic: an interrupted save (second Ctrl-C, disk full) must not
    # corrupt the previous checkpoint
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(snapshot(tracker, cache, stats))
    os.replace(tmp, path)


def load(path: str, tracker, cache, stats) -> None:
    with open(path) as f:
        restore(f.read(), tracker, cache, stats)
