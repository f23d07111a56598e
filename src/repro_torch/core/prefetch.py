"""Prefetch-operation construction + bank-conflict accounting — paper §3.2/§4.

Each register-interval gets one :class:`PrefetchOp` carrying the interval's
working-set bit-vector.  The MRF is ``num_banks`` single-ported banks, so a
prefetch completes in ``max_bank_occupancy`` serial bank rounds; the paper
counts an interval as having *N conflicts* when some bank holds N+1 of its
registers.

Copy of ``repro.core.prefetch`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from .intervals import IntervalAnalysis
from .renumber import bank_of


@dataclass(frozen=True)
class PrefetchOp:
    interval_id: int
    bitvector: frozenset[int]  # registers to fetch (architectural ids)
    bank_occupancy: tuple[int, ...]  # per-bank register counts

    @property
    def conflicts(self) -> int:
        return max(self.bank_occupancy, default=0) - 1 if self.bitvector else 0

    @property
    def serial_rounds(self) -> int:
        """Serial bank rounds the prefetch needs (1 == conflict-free)."""
        return max(self.bank_occupancy, default=1) if self.bitvector else 1


def prefetch_schedule(
    analysis: IntervalAnalysis,
    num_banks: int = 16,
    scheme: str = "interleaved",
    regs_per_bank: int = 2,
) -> list[PrefetchOp]:
    ops = []
    for iv in analysis.intervals:
        occ = [0] * num_banks
        for r in iv.working_set:
            occ[bank_of(r, num_banks, scheme, regs_per_bank)] += 1
        ops.append(PrefetchOp(interval_id=iv.iid,
                              bitvector=frozenset(iv.working_set),
                              bank_occupancy=tuple(occ)))
    return ops


def conflict_distribution(ops: list[PrefetchOp]) -> dict[int, float]:
    """Fraction of prefetch operations with exactly N bank conflicts."""
    if not ops:
        return {0: 1.0}
    c = Counter(op.conflicts for op in ops)
    total = sum(c.values())
    return {k: v / total for k, v in sorted(c.items())}


def code_size_overhead(analysis: IntervalAnalysis, bitvec_bits: int = 256,
                       instr_bits: int = 64, explicit_instr: bool = False) -> float:
    """Fractional static code-size increase from embedding prefetch bit-vectors
    (§5.3: ~7% bit-vector-only, ~9% with explicit prefetch instructions)."""
    base = analysis.prog.num_instrs() * instr_bits
    extra = len(analysis.intervals) * (bitvec_bits + (instr_bits if explicit_instr else 0))
    return extra / max(base, 1)
