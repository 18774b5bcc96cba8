"""The working shapes of the device paths, and every rule that changes them.

A dispatch is shaped for `mc` preamble candidates a buffer and the messages
a batch emits: `mos` short and `mol` long rows packed, `mo` unpacked.  Exact
counts come back with every result, so an overflow is found, never
truncated, and the shapes grow x4 and stay grown: a group to its peaks in
one go, then replayed (Shapes.fit); a retry x4 an attempt up to
MAX_BUFFER_CANDIDATES (step, Shapes.redo, Shapes.retry).  Quiet air shrinks
them (Shapes.shrink)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

from ..constants import MAX_BUFFER_CANDIDATES
from ..ops.demod import Candidates
from ..ops.resolve import clamp_packed_out, max_candidates_cap, normalize_max_candidates
from .resolver import BlockCandidates

QUIET_GROUPS = 3
FLOORS = (64, 2048, 2048, 4096)  # of (mc, mos, mol, mo) after a shrink


class Peaks(NamedTuple):
    """A dispatch's densest exact counts, in Shapes.key's order."""

    n: int
    short: int = 0
    long: int = 0
    total: int = 0


def peaks(host: list, packed: bool) -> Peaks:
    """The peaks of a fetched group (n, count, count_long if packed, ...)."""
    n, count = int(host[0].max(initial=0)), host[1]
    if packed:
        return Peaks(n, int((count - host[2]).max(initial=0)), int(host[2].max(initial=0)))
    return Peaks(n, total=int(count.max(initial=0)))


def step(mc: int, err: Exception, normalize: bool = False) -> int:
    """The candidate shape to try after `mc` overflowed: 4x, rounded up to
    the resolve chunk with `normalize`.  Past the ceiling, raises `err`."""
    if mc >= MAX_BUFFER_CANDIDATES:
        raise err
    return normalize_max_candidates(mc * 4) if normalize else mc * 4


def _grow(shape: int, peak: int) -> int:
    while shape < peak:
        shape *= 4
    return shape


@dataclass
class Shapes:
    """A session's shapes; the host path never sizes the emission ones."""

    mc: int
    mos: int | None = None
    mol: int | None = None
    mo: int | None = None
    quiet: int = 0  # groups in a row far below the shapes

    @property
    def key(self) -> tuple:
        return (self.mc, self.mos, self.mol, self.mo)

    def size(self, nb: int) -> None:
        """Size the emission shapes of nb-buffer batches on first use (dense
        real air fits without a replay); restart the quiet count."""
        self.quiet = 0
        if self.mo is None:
            self.mo = max(4096, nb * self.mc // 2)
        if self.mos is None:
            self.mos, self.mol = clamp_packed_out(max(2048, nb * self.mc // 4),
                                                  max(2048, nb * self.mc // 3))

    def fit(self, pk: Peaks, ran: tuple, *, packed: bool, n_buffers: int | None = None) -> bool:
        """Whether a group that ran with the shapes `ran` is replayed: if
        its peaks overflow them, each overflowing shape grows x4 until it
        holds its peak; mc stops at the cap of an n_buffers group, and the
        packed emission shapes within the wire format's rank field."""
        if all(p <= s for p, s in zip(pk, ran)):
            return False
        self.mc = _grow(self.mc, pk.n)
        if n_buffers is not None and self.mc > (cap := max_candidates_cap(n_buffers)):
            if pk.n > cap:
                raise RuntimeError(
                    f"a buffer reported {pk.n} preamble candidates but a group of "
                    f"{n_buffers} buffers may hold at most {cap} per buffer on the "
                    f"device — lower --tpu-batch"
                )
            self.mc = cap
        self.mos, self.mol = _grow(self.mos, pk.short), _grow(self.mol, pk.long)
        if packed:  # raises if the peaks themselves cannot fit
            self.mos, self.mol = clamp_packed_out(self.mos, self.mol, pk.short, pk.long)
        self.mo = _grow(self.mo, pk.total)
        return True

    def shrink(self, pk: Peaks) -> bool:
        """Count a group whose peaks are an eighth of the shapes or less
        (any other restarts the count); the QUIET_GROUPS-th divides every
        shape by 4, down to FLOORS.  Returns whether they changed."""
        self.quiet = self.quiet + 1 if all(p * 8 <= s for p, s in zip(pk, self.key)) else 0
        if self.quiet < QUIET_GROUPS:
            return False
        self.quiet, before = 0, self.key
        self.mc, self.mos, self.mol, self.mo = (max(f, s // 4) for f, s in zip(FLOORS, before))
        return self.key != before

    def redo(self, demod, mc: int, err: OverflowError) -> tuple[list, BlockCandidates]:
        """Demodulate one buffer that overflowed `mc` candidate slots again
        alone, `demod(mc)` -> its fetched fields (Candidates first), a step
        up each time until they fit, and keep the larger shape, so dense
        air retries once, not per buffer.  Returns (fields, candidates)."""
        while True:
            mc = step(mc, err)
            host = demod(mc)
            try:
                bc = BlockCandidates.from_device(Candidates(*host[:8]))
            except OverflowError as e:
                err = e
                continue
            self.mc = max(self.mc, mc)
            return host, bc

    def retry(self, pk: Peaks, who: str, normalize: bool = False) -> bool:
        """Whether a round with peaks pk runs again: mc steps up if `who`
        overflowed it, else mo grows x4 if the messages overflowed it."""
        if pk.n > self.mc:
            self.mc = step(self.mc, OverflowError(
                f"candidate overflow: {who} reported {pk.n} preambles > max_candidates {self.mc}"
            ), normalize)
            return True
        if pk.total > self.mo:
            self.mo *= 4
            return True
        return False
