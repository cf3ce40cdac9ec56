"""Data-oblivious encrypted sorting: bitonic networks, one dispatch per stage.

FHE evaluation cannot branch on encrypted data, so sorting must be a
data-oblivious network. A bitonic sorter's compare-exchange schedule is
static, and all K/2 exchanges within a stage are independent — so each
stage lowers to ONE batched comparator and ONE batched swap-select over
the whole (pairs x batch x width) volume: O(log^2 K) sequential stages,
each one batched gate/PBS program,
instead of the reference's per-ciphertext loops (its comparator sketch,
src/circuits.rs, is 9 LoC of dead code — rs-tfhe has no sorting at all).

Two integer representations are supported, mirroring the rest of models/:
  - bit vectors  [K, ..., W, n0+1]  (gate circuits: models.circuits)
  - radix digits [K, ..., D, n0+1]  (LUT arithmetic: models.arithmetic)
The leading axis is the array being sorted; any batch axes in between sort
independently and ride the same dispatches for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import gates
from ..key import CloudKey
from ..tlwe import lwe_trivial_message
from . import arithmetic
from .circuits import greater_than


def _bitonic_schedule(k: int):
    """Static compare-exchange schedule for a k-element bitonic network.

    k must be a power of two. Returns a list of stages; each stage is
    (lo, hi, desc): numpy index arrays of the pair endpoints and a bool
    mask marking pairs whose enclosing run sorts descending. Stage count
    is log2(k)*(log2(k)+1)/2; every stage holds exactly k/2 pairs.
    """
    assert k & (k - 1) == 0 and k > 0, "bitonic network needs a power of two"
    stages = []
    size = 2
    while size <= k:
        stride = size // 2
        while stride >= 1:
            i = np.arange(k)
            lo = i[(i % (2 * stride)) < stride]
            hi = lo + stride
            desc = (lo & size) != 0
            stages.append((lo, hi, desc))
            stride //= 2
        size *= 2
    return stages


def _next_pow2(k: int) -> int:
    p = 1
    while p < k:
        p *= 2
    return p


def _run_network(x: jax.Array, exchange) -> jax.Array:
    """Drive the schedule: x is [Kp, ...]; `exchange(a, b, desc)` returns the
    (new_lo, new_hi) batch for one stage's pair endpoints."""
    # The fancy indexing below is HOST-SIDE orchestration between bootstrap
    # dispatches over the tiny K axis, outside any jitted hot path — the
    # CLAUDE.md no-gathers rule targets in-kernel/in-scan code. Restructure
    # with static slices if the network ever moves inside jit.
    for lo, hi, desc in _bitonic_schedule(x.shape[0]):
        new_lo, new_hi = exchange(x[lo], x[hi], desc)
        x = x.at[lo].set(new_lo).at[hi].set(new_hi)
    return x


def _stage_select(swap: jax.Array, desc: np.ndarray) -> jax.Array:
    """Flip the swap bit on the descending pairs — plaintext direction, so
    the flip is the bootstrap-free NOT (exact negation), selected per pair
    with a static mask."""
    if not desc.any():
        return swap
    mask = jnp.asarray(desc).reshape(desc.shape[0], *([1] * (swap.ndim - 1)))
    return jnp.where(mask, gates.not_(swap), swap)


def sort_bits(x: jax.Array, ck: CloudKey, descending: bool = False) -> jax.Array:
    """Sort K encrypted W-bit unsigned integers (ascending by default).

    x: uint32 [K, ..., W, n0+1] bit vectors (LSB first, as in bit_utils);
    returns the same shape with the K axis sorted. Non-power-of-two K is
    padded with trivial MAX sentinels that sort to the far end and are
    sliced off — the network itself always runs at the next power of two.

    Per stage: one batched `greater_than` (W serial comparator rounds, each
    a whole-stage gate dispatch) and one batched MUX performing both swap
    outputs in a single call. Total bootstrapped-gate dispatches:
    O(log^2 K * W) regardless of K's size or any batch dims.
    """
    k = x.shape[0]
    if k <= 1:
        return x
    kp = _next_pow2(k)
    if kp != k:
        ones = gates.constant(True, 1, ck.params)[0]
        pad = jnp.broadcast_to(ones, (kp - k, *x.shape[1:]))
        x = jnp.concatenate([x, pad], axis=0)

    def exchange(a, b, desc):
        gt = greater_than(a, b, ck)  # [P, ..., n0+1]
        s = _stage_select(gt, desc)
        sel = jnp.broadcast_to(s[None, ..., None, :], (2, *a.shape))
        # one MUX dispatch computes both outputs: row 0 = min side (lo),
        # row 1 = max side (hi) of each ascending pair
        out = gates.mux(
            sel,
            jnp.stack([b, a], axis=0),
            jnp.stack([a, b], axis=0),
            ck,
        )
        return out[0], out[1]

    x = _run_network(x, exchange)
    if descending:
        x = x[::-1]
        return x[kp - k:] if kp != k else x
    return x[:k]


def top_k_bits(x: jax.Array, k: int, ck: CloudKey, largest: bool = True):
    """The k largest (or smallest) of K encrypted integers, sorted.

    Runs the full network and slices — data-oblivious by construction (a
    partial network would leak nothing either, but the full sort keeps the
    result fully ordered)."""
    return sort_bits(x, ck, descending=largest)[:k]


def sort_radix(
    x: jax.Array,
    ck: CloudKey,
    base_bits: int = 3,
    descending: bool = False,
    multi_value: bool = False,
) -> jax.Array:
    """Sort K encrypted radix integers [K, ..., D, n0+1] along the K axis.

    LUT-arithmetic counterpart of `sort_bits`: each stage costs one batched
    `compare_radix` (1 + ceil(log2 D) blind rotations) and one batched
    `select_radix` performing both swap outputs (3 rotations) — the swap's
    select refresh keeps every element at fresh-digit noise, so depth
    composes within add_radix's certified envelope. `multi_value` threads
    through to the comparator (factored test vectors, ~half the rotations).
    """
    k = x.shape[0]
    if k <= 1:
        return x
    kp = _next_pow2(k)
    if kp != k:
        base = 1 << base_bits
        maxdig = lwe_trivial_message(
            jnp.full((kp - k, *x.shape[1:-1]), base - 1, dtype=jnp.uint32),
            2 * base,
            ck.params.n0,
        )
        x = jnp.concatenate([x, maxdig], axis=0)

    def exchange(a, b, desc):
        _, gt, _ = arithmetic.compare_radix(
            a, b, ck, base_bits, multi_value=multi_value
        )
        s = _stage_select(gt, desc)
        sel = jnp.broadcast_to(s[None], (2, *s.shape))
        out = arithmetic.select_radix(
            sel,
            jnp.stack([b, a], axis=0),
            jnp.stack([a, b], axis=0),
            ck,
            base_bits,
        )
        return out[0], out[1]

    x = _run_network(x, exchange)
    if descending:
        x = x[::-1]
        return x[kp - k:] if kp != k else x
    return x[:k]
