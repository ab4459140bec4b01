"""The frozen work-list buckets' one owner (ops/frozen_graph.Buckets).

Every verify site keeps its buckets in a Buckets: CulledRenderer's
render_fast and render_dynamic (one count vector), freeze_bounced's render
and the bounced bands (one vector per bounce) and the culled halo and ring
(per bounce, the primary then the shadow levels). For each of the three
layouts: the first freeze equals the JAX package's rule on the same counts
(bucket_w_pad, the hit-TILE slot through _tile_bucket capped at n_tiles),
a refreeze never shrinks a bucket and is the leafwise max of the rule's
buckets and the current ones, and `fits` is true exactly when every count
is at most its bucket.
"""

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.pallas.bsr_trace import bucket_w_pad
from distributed_raytracer_tpu.ops.render_bvh import _tile_bucket
from distributed_raytracer_tpu_torch.ops import frozen_graph

NL = 3            # cull levels
N_TILES = 600     # ray tiles: the hit-TILE slot's cap
BOUNCES = 3
LAYOUTS = ["flat", "per bounce", "per bounce halves"]


def counts_of(g: np.random.Generator, layout: str) -> list:
    """Counts of one frame in `layout` as nested lists of ints, spanning
    every branch of the rule: the 256 floor, powers of two up to 2048,
    2048-multiples per 16,384-item segment, the tile cap."""
    width = 2 * NL if layout == "per bounce halves" else 2 * NL + 1
    shape = (width,) if layout == "flat" else (BOUNCES, width)
    scale = 10.0 ** g.uniform(0, 5, size=shape)
    return np.floor(scale * g.random(shape)).astype(np.int64).tolist()


def jax_rule(counts, margin: float, hit) -> tuple:
    """The JAX package's buckets of one vector or of one per bounce."""
    if isinstance(counts[0], list):
        return tuple(jax_rule(c, margin, hit) for c in counts)
    return tuple(_tile_bucket(int(c * margin), N_TILES) if k == hit
                 else bucket_w_pad(c, margin) for k, c in enumerate(counts))


def leaves(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64).ravel()


def flat(x) -> list:
    return [y for v in x for y in flat(v)] if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_buckets_follow_the_rule_grow_only_and_fit_exactly(layout):
    g = np.random.default_rng(LAYOUTS.index(layout))
    hit = None if layout == "per bounce halves" else NL
    margin = 1.4 if layout == "flat" else 2.0
    buckets = frozen_graph.Buckets(margin, hit=hit, n_tiles=N_TILES)
    assert buckets.pads is None

    # The first freeze: the rule at its own margin.
    first = counts_of(g, layout)
    buckets.grow(first, 3.0)
    assert buckets.pads == jax_rule(first, 3.0, hit)
    assert all(type(p) is int for p in flat(buckets.pads))
    hash(buckets.pads)                   # graph keys hash them

    # Refreezes at the refreeze margin: leafwise max, never a shrink.
    for _ in range(20):
        old = buckets.pads
        counts = counts_of(g, layout)
        buckets.grow(counts)
        new = buckets.pads
        assert (leaves(new) >= leaves(old)).all()
        assert (leaves(new) == np.maximum(
            leaves(jax_rule(counts, margin, hit)), leaves(old))).all()
        assert type(new) is tuple and np.shape(new) == np.shape(old)

    # fits: exactly every count within its bucket.
    pads = leaves(buckets.pads)
    for step in range(40):
        counts = pads.copy()
        if step % 2:
            k = g.integers(pads.size)
            counts[k] += g.integers(1, 3)
        counts -= g.integers(0, 2, size=pads.size) * (step % 4 == 0)
        nested = counts.reshape(np.shape(buckets.pads)).tolist()
        assert buckets.fits(nested) == bool((counts <= pads).all())
    assert buckets.fits(np.zeros(np.shape(buckets.pads), int).tolist())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_check_holds_the_worst_counts_and_regrows(layout):
    """A verify check reads the frame's counts through `worst` (the max
    over bands or ranks, the columns the buckets bound), refreezes at the
    refreeze margin and tells on_grow the counts it grew from."""
    hit = None if layout == "per bounce halves" else NL
    seen = []
    if layout == "flat":
        worst = None                        # render_fast: the counts
    elif layout == "per bounce":
        worst = lambda c: c.amax(dim=0).tolist()        # the bands
    else:                                   # the ring: 2 extra columns
        worst = lambda c: c.amax(dim=0)[:, :2 * NL].tolist()
    buckets = frozen_graph.Buckets(1.4, hit=hit, n_tiles=N_TILES,
                                   worst=worst, on_grow=seen.append)
    g = np.random.default_rng(7)
    buckets.grow(counts_of(g, layout))
    pads = torch.tensor(buckets.pads)
    frame = pads + 1                        # every count overflows
    if hit is not None:                     # but the capped hit-TILE slot
        frame[..., hit] = pads[..., hit]
    if layout == "per bounce":
        frame = torch.stack([pads, frame])
    elif layout == "per bounce halves":
        extra = torch.zeros(BOUNCES, 2, dtype=frame.dtype)
        frame = torch.cat([frame, extra], dim=1)
        frame = torch.stack([frame, frame - 1])
    rounds = []

    def again():
        rounds.append(1)
        return "again", frame
    check = buckets.check("out", frame, again, "test")
    want = (frame if layout == "flat" else frame.amax(dim=0))
    want = want[..., :pads.shape[-1]]
    assert seen and seen[0] == want.tolist()
    assert buckets.pads == jax_rule(want.tolist(), 1.4, hit)
    assert check.out == "again" and len(rounds) == 1
