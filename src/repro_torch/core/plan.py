"""IntervalPlan: the paper's interval analysis applied to model layer graphs.

Copy of ``repro.core.plan`` for the PyTorch port: the same text.  On
Hopper a "tile" is a shared-memory operand block and the budget is shared
memory per CTA; the text below keeps the reference's TPU wording (VMEM) for
the same roles.

This is the bridge between Layer A (the GPU compiler passes) and Layer B (the
TPU runtime/kernels).  A model is lowered to a tiny *tile program*: each
layer-group is a basic block whose "registers" are its weight/state tiles
(one tile = one VMEM-resident operand block).  Running the SAME
`form_register_intervals` + ICG coloring over that program yields:

  * **intervals** — runs of layers whose aggregate tile working set fits the
    VMEM budget: one HBM->VMEM prefetch per interval, issued ahead of
    compute (the kernels' multi-buffered pipeline depth comes from here);
  * **slot coloring** — tiles co-fetched in an interval get distinct buffer
    slots (the bank-conflict pass; a slot still being read is never the
    target of the next DMA);
  * **PrefetchOp list** — the explicit, inspectable HW/SW contract that the
    paper encodes as ISA bit-vectors.

Used by `kernels/ltrf_matmul` (tile order + buffer depth) and by the runtime
to choose per-layer-group streaming/remat policy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .coloring import chaitin_color
from .ir import parse_asm
from .plan_cache import cached_intervals


@dataclass(frozen=True)
class Tile:
    name: str
    bytes: int


@dataclass
class LayerNode:
    name: str
    tiles: list[Tile]
    flops: int = 0


@dataclass
class TilePrefetch:
    interval_id: int
    layer_names: list[str]
    tiles: list[Tile]
    slots: dict[str, int]  # tile name -> buffer slot
    fetch_bytes: int = 0   # exact bytes this round DMAs (granule-accurate:
                           # a tile split across rounds is fetched partially)

    @property
    def bytes(self) -> int:
        return self.fetch_bytes or sum(t.bytes for t in self.tiles)


@dataclass
class IntervalPlan:
    prefetches: list[TilePrefetch]
    vmem_budget: int
    num_slots: int
    tile_bytes: int

    @property
    def num_intervals(self) -> int:
        return len(self.prefetches)

    def max_interval_bytes(self) -> int:
        return max((p.bytes for p in self.prefetches), default=0)

    def validate(self) -> None:
        for p in self.prefetches:
            # granule-accurate fetch bytes never exceed the budget (a single
            # granule bigger than the budget is impossible by construction)
            assert p.bytes <= self.vmem_budget + self.tile_bytes
            # Slot reuse within one fetch round is bounded: co-fetched tiles
            # form a clique, so balanced coloring hands each slot at most
            # ceil(tiles / num_slots) of them.  A slot reused beyond that
            # bound would serialize the DMA stream behind a single buffer.
            used: dict[int, list[str]] = {}
            for t in p.tiles:
                used.setdefault(p.slots[t.name], []).append(t.name)
            bound = -(-len(p.tiles) // max(self.num_slots, 1))
            for s, names in used.items():
                assert len(names) <= bound, (
                    f"slot {s} reused {len(names)}x in interval "
                    f"{p.interval_id} (bound {bound}): {names}")
        # conflict-free within a fetch round: tiles fetched together should
        # map to distinct slots whenever enough slots exist
        for p in self.prefetches:
            if len(p.tiles) <= self.num_slots:
                vals = [p.slots[t.name] for t in p.tiles]
                assert len(set(vals)) == len(vals), "slot conflict"


def _balanced_slots(names: list[str], idx: dict[str, int],
                    colors: dict[int, int], num_slots: int) -> dict[str, int]:
    """Per-round buffer-slot assignment derived from the global coloring.

    The ICG coloring is a preference, not a guarantee: a tile constrained by
    *other* intervals' cliques can land on a slot already taken in this round.
    Rebalance within the round so no slot serves more than
    ceil(tiles/num_slots) tiles — the bound `IntervalPlan.validate` enforces —
    while keeping the colored slot whenever it is still under that bound.
    """
    bound = -(-len(names) // max(num_slots, 1))
    usage = [0] * max(num_slots, 1)
    out: dict[str, int] = {}
    for n in names:
        s = colors[idx[n]] % num_slots
        if usage[s] >= bound:
            s = min(range(num_slots), key=lambda c: (usage[c], c))
        out[n] = s
        usage[s] += 1
    return out


def plan_layer_stream(
    layers: list[LayerNode],
    vmem_budget: int,
    num_slots: int = 4,
) -> IntervalPlan:
    """Plan HBM->VMEM streaming for a sequential layer graph.

    Tiles are quantized to a common granule so the interval pass (which
    counts registers) can bound bytes: granule = vmem_budget / cap where cap
    is chosen so each granule is one 'register'.
    """
    cap = 64  # registers per interval (VMEM granules)
    granule = max(1, vmem_budget // cap)

    # Build the tile program: one block per layer; each tile occupies
    # ceil(bytes/granule) registers so the working-set cap == byte budget.
    reg_of_tile: dict[str, list[int]] = {}
    next_reg = 0
    lines = []
    for li, layer in enumerate(layers):
        lines.append(f"L{li}: nop")
        for t in layer.tiles:
            regs = reg_of_tile.get(t.name)
            if regs is None:
                n = max(1, -(-t.bytes // granule))
                regs = list(range(next_reg, next_reg + n))
                next_reg += n
                reg_of_tile[t.name] = regs
            # touch every granule of the tile in this layer
            for r in regs:
                lines.append(f"add r{r}, r{r}, r{r}")
    lines.append("exit")
    prog = parse_asm("\n".join(lines), name="layer-stream")
    # memoized: repeated plans over the same layer graph compile once
    analysis = cached_intervals(prog, cap)

    # Map intervals back to layers + tiles.
    reg_to_tile = {}
    for name, regs in reg_of_tile.items():
        for r in regs:
            reg_to_tile[r] = name
    tile_by_name = {t.name: t for layer in layers for t in layer.tiles}
    layer_of_block = {}
    for li in range(len(layers)):
        layer_of_block[f"L{li}"] = layers[li].name

    # Slot coloring: tiles co-fetched in one interval must take different
    # buffer slots (ICG over tiles, colored with num_slots colors).
    tiles_per_interval: list[list[str]] = []
    for iv in analysis.intervals:
        names = []
        for r in sorted(iv.working_set):
            n = reg_to_tile.get(r)
            if n is not None and n not in names:
                names.append(n)
        tiles_per_interval.append(names)
    all_tiles = sorted({n for ns in tiles_per_interval for n in ns})
    idx = {n: i for i, n in enumerate(all_tiles)}
    adj = {i: set() for i in range(len(all_tiles))}
    for ns in tiles_per_interval:
        ids = [idx[n] for n in ns]
        for i, a in enumerate(ids):
            for b in ids[i + 1:]:
                adj[a].add(b)
                adj[b].add(a)
    coloring = chaitin_color(adj, num_slots)

    prefetches = []
    for k, iv in enumerate(analysis.intervals):
        names = tiles_per_interval[k]
        if not names:
            continue
        lnames = sorted({layer_of_block[b.split(".")[0]] for b in iv.blocks
                         if b.split(".")[0] in layer_of_block})
        n_granules = sum(1 for r in iv.working_set if r in reg_to_tile)
        prefetches.append(TilePrefetch(
            interval_id=iv.iid,
            layer_names=lnames,
            tiles=[tile_by_name[n] for n in names],
            slots=_balanced_slots(names, idx, coloring.colors, num_slots),
            fetch_bytes=n_granules * granule,
        ))
    plan = IntervalPlan(prefetches=prefetches, vmem_budget=vmem_budget,
                        num_slots=num_slots, tile_bytes=granule)
    return plan


def plan_for_matmul(m: int, k: int, n: int, bk: int, bn: int,
                    vmem_budget: int, num_slots: int = 2,
                    dtype_bytes: int = 2) -> IntervalPlan:
    """Interval plan for a K/N-blocked matmul's weight-tile stream.

    Each (bk x bn) weight tile is one 'register'; intervals group the tile
    stream into VMEM-budget-sized prefetch rounds; slots alternate so DMA of
    round i+1 never lands in a buffer still being read by round i."""
    layers = []
    for j in range(-(-n // bn)):
        tiles = [Tile(name=f"w_{i}_{j}", bytes=bk * bn * dtype_bytes)
                 for i in range(-(-k // bk))]
        layers.append(LayerNode(name=f"col{j}", tiles=tiles,
                                flops=2 * m * k * bn))
    return plan_layer_stream(layers, vmem_budget, num_slots=num_slots)
