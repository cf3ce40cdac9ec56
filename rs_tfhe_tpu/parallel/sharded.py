"""Multi-chip bootstrapped gate evaluation: data- and tensor-parallel.

Two strategies (composable on a 2-D ``(batch, model)`` mesh):

**Data parallel (the production path).** Independent ciphertexts never
communicate — the multi-chip analogue of the reference's
``batch_blind_rotate_with_railgun`` (rs-tfhe trgsw.rs:289-305). The batch axis
is sharded, every key replicated; under ``jit`` with input shardings XLA emits
zero collectives and each chip runs its own slice of the fused bootstrap scan.

**Tensor parallel (scale *within* one bootstrap).** For latency-bound small
batches, the two heavy contractions inside a bootstrap are sharded over the
``model`` axis with one ``psum`` each:

  - external product: the TRGSW row axis (2L gadget rows) of the BSK is
    sharded; each chip contracts its rows against the matching slice of the
    decomposed digits, then ``psum`` reconstitutes the CMUX delta
    (reference loop: trgsw.rs:103-105);
  - key switching: the lv1-coefficient axis (N rows of the KSK table) is
    sharded; partial subtracted sums are ``psum``-reduced
    (reference loop: trgsw.rs:347-356).

Both collectives are all-reduces over the `model` axis (NCCL over NVLink
on a multi-GPU host); nothing ever gathers full keys to one device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bootstrap import bootstrap as _bootstrap
from ..gates import _LINEAR_FORMS
from ..key import CloudKey
from ..ops.blind_rotate import modswitch
from ..ops.decompose import gadget_decompose
from ..ops.extract import sample_extract
from ..ops.keyswitch import digit_select_sum
from ..ops.poly import build_step_matrix, monomial_rotate, polymul_small_by_torus_multi
from .mesh import BATCH_AXIS, MODEL_AXIS, batch_spec, pad_to_multiple, replicate, shard_batch

# ---------------------------------------------------------------------------
# Data-parallel path: jit + shardings, zero collectives
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("name", "mesh", "impl"))
def _dp_gate(
    name: str, a: jax.Array, b: jax.Array, ck: CloudKey, mesh: Mesh,
    impl: str = "auto",
) -> jax.Array:
    # `impl` keys the jit cache on config.step_impl (read at trace time
    # inside blind_rotate) — see gates._gate2.
    del impl

    def shard_fn(a_l, b_l, ck_l):
        return _bootstrap(_LINEAR_FORMS[name](a_l, b_l), ck_l)

    # explicit shard_map (not sharding propagation): each device runs the
    # whole bootstrap on its local batch slice, with keys replicated. Zero
    # collectives.
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(batch_spec(2), batch_spec(2), P()),
        out_specs=batch_spec(2),
        check_vma=False,
    )(a, b, ck)


def data_parallel_gate(
    name: str, a: jax.Array, b: jax.Array, ck: CloudKey, mesh: Mesh
) -> jax.Array:
    """Evaluate one gate over a batch sharded across the mesh's batch axis.

    a, b: uint32 [B, n0+1]. B is padded up to a multiple of the batch-axis
    size; the pad rows are dropped from the result.
    """
    from ..config import config

    n_batch = mesh.shape[BATCH_AXIS]
    a_pad, size = pad_to_multiple(a, n_batch)
    b_pad, _ = pad_to_multiple(b, n_batch)
    a_sh = shard_batch(a_pad, mesh)
    b_sh = shard_batch(b_pad, mesh)
    ck_rep = replicate(ck, mesh)
    return _dp_gate(name, a_sh, b_sh, ck_rep, mesh, config.step_impl)[:size]


@partial(jax.jit, static_argnames=("mesh", "impl"))
def _dp_mux(a, b, c, ck: CloudKey, mesh: Mesh, impl: str = "auto"):
    from ..gates import _mux_impl

    def shard_fn(a_l, b_l, c_l, ck_l):
        # Thread the outer static impl through: _mux_impl is independently
        # jitted, so calling it with its default ("auto") would freeze the
        # config.step_impl read at its first trace (CLAUDE.md invariant).
        return _mux_impl(a_l, b_l, c_l, ck_l, impl)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(batch_spec(2), batch_spec(2), batch_spec(2), P()),
        out_specs=batch_spec(2),
        check_vma=False,
    )(a, b, c, ck)


def data_parallel_mux(a, b, c, ck: CloudKey, mesh: Mesh) -> jax.Array:
    """MUX(a; b, c) with the batch axis sharded (3 blind rotations per
    element, all chip-local; zero collectives)."""
    from ..config import config

    n_batch = mesh.shape[BATCH_AXIS]
    a_pad, size = pad_to_multiple(a, n_batch)
    b_pad, _ = pad_to_multiple(b, n_batch)
    c_pad, _ = pad_to_multiple(c, n_batch)
    return _dp_mux(
        shard_batch(a_pad, mesh), shard_batch(b_pad, mesh),
        shard_batch(c_pad, mesh), replicate(ck, mesh), mesh,
        config.step_impl,
    )[:size]


@partial(jax.jit, static_argnames=("mesh", "impl"))
def _dp_lut(ct, lut_poly, ck: CloudKey, mesh: Mesh, impl: str = "auto"):
    del impl
    from ..bootstrap import bootstrap_with_testvec

    def shard_fn(ct_l, lut_l, ck_l):
        return bootstrap_with_testvec(ct_l, lut_l, ck_l)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(batch_spec(2), P(), P()),
        out_specs=batch_spec(2),
        check_vma=False,
    )(ct, lut_poly, ck)


def data_parallel_lut_bootstrap(
    ct: jax.Array, f, message_modulus: int, ck: CloudKey, mesh: Mesh
) -> jax.Array:
    """Programmable bootstrap with the batch sharded; the LUT polynomial is
    built ONCE on the host and replicated (the reference rebuilds it per
    call inside the hot path, bootstrap/lut.rs:49-65)."""
    from ..config import config
    from ..lut.generator import Generator

    lut = Generator(message_modulus, ck.params).generate_lookup_table(f)
    n_batch = mesh.shape[BATCH_AXIS]
    ct_pad, size = pad_to_multiple(ct, n_batch)
    lut_rep = jax.device_put(lut.poly, NamedSharding(mesh, P()))
    return _dp_lut(
        shard_batch(ct_pad, mesh), lut_rep, replicate(ck, mesh), mesh,
        config.step_impl,
    )[:size]


# ---------------------------------------------------------------------------
# Tensor-parallel bootstrap (shard_map over (batch, model))
# ---------------------------------------------------------------------------


def _tp_step_delta(d_local, bsk_i, params):
    """Local partial CMUX delta via the circulant contraction (local gadget
    rows only)."""
    mat = build_step_matrix(bsk_i)
    return polymul_small_by_torus_multi(d_local, mat, params.digit_limbs, 2)


def _tp_blind_rotate(ct, testvec, bsk_local, params, tp: int):
    """Blind rotation with the BSK's 2L gadget-row axis sharded over `model`.

    ct: uint32 [B_loc, n0+1]; bsk_local: uint32 [n0, 2L/tp, 2, N].
    Mirrors ops/blind_rotate.blind_rotate with a psum'd CMUX delta.

    COST MODEL: this path emits ONE psum of [B_loc, 2, N] uint32 per CMUX
    step — n0 (700) all-reduces per bootstrap, ~8 KB each at B_loc=1 and
    N=1024. The cards of one host are joined all to all by NVLink, so each
    all-reduce is latency-bound at small batch: TP can only pay off for
    latency-bound SMALL batches where the batch axis cannot fill the
    devices; throughput workloads use data_parallel_gate (zero
    collectives). The crossover has not been measured on GPUs.
    """
    g = params.trgsw_lv1
    n0, n1 = params.n0, params.n1
    batch = ct.shape[0]
    rows_local = (2 * g.l) // tp
    row0 = jax.lax.axis_index(MODEL_AXIS) * rows_local

    b_til = (2 * n1 - modswitch(ct[:, n0], params)) % (2 * n1)
    a_til = modswitch(ct[:, :n0], params)

    tv = jnp.broadcast_to(testvec, (batch, 2, n1))
    acc0 = monomial_rotate(tv, b_til[:, None])

    def step(acc, xs):
        bsk_i, a_i = xs
        rot = monomial_rotate(acc, a_i[:, None])
        digits = gadget_decompose(rot - acc, params)  # [B, 2L, N]
        d_local = jax.lax.dynamic_slice_in_dim(digits, row0, rows_local, axis=-2)
        delta = _tp_step_delta(d_local, bsk_i, params)
        delta = jax.lax.psum(delta, MODEL_AXIS)
        return acc + delta, None

    acc, _ = jax.lax.scan(step, acc0, (bsk_local, a_til.T))
    return acc


def _tp_key_switch(lv1, ksk_local, params, tp: int):
    """Key switch lv1->lv0 with the KSK's N-coefficient axis sharded.

    lv1: uint32 [B_loc, N+1]; ksk_local: int8 [(N/tp)*t*base, 4*lane_pad(n0+1)]
    (planar-padded, tlwe.lwe_encrypt_rows_limbs).
    """
    g = params.trgsw_lv1
    n1, out_w = params.n1, params.n0 + 1
    cols_local = n1 // tp
    col0 = jax.lax.axis_index(MODEL_AXIS) * cols_local

    a_local = jax.lax.dynamic_slice_in_dim(lv1[..., :n1], col0, cols_local, axis=-1)
    ksk_flat = ksk_local.reshape(-1, ksk_local.shape[-1])  # [(N/tp)*t*base, 4*P]
    partial_sum = digit_select_sum(a_local, ksk_flat, g.iks_t, g.basebit, out_w)
    subtrahend = jax.lax.psum(partial_sum, MODEL_AXIS)

    res = jnp.zeros((*lv1.shape[:-1], out_w), dtype=jnp.uint32)
    res = res.at[..., -1].set(lv1[..., n1])
    return res - subtrahend


def tensor_parallel_bootstrap(
    ct: jax.Array, ck: CloudKey, mesh: Mesh, testvec: jax.Array | None = None
) -> jax.Array:
    """Full gate bootstrap with batch sharded over `batch` and both key
    contractions sharded over `model`. ct: uint32 [B, n0+1] (B divisible by
    the batch-axis size; 2L and N divisible by the model-axis size).
    `testvec` overrides the gate test vector — the TP programmable-
    bootstrap hook (see tensor_parallel_lut_bootstrap).

    Scope (measured honestly): one psum per CMUX step = n0 collectives per
    bootstrap; use for latency-bound batches too small to fill the mesh's
    batch axis. data_parallel_gate is the throughput path."""
    params = ck.params
    tp = mesh.shape[MODEL_AXIS]
    g = params.trgsw_lv1
    if (2 * g.l) % tp or params.n1 % tp:
        raise ValueError(f"tp={tp} must divide 2L={2 * g.l} and N={params.n1}")

    def fn(ct_l, testvec, bsk_l, ksk_l):
        acc = _tp_blind_rotate(ct_l, testvec, bsk_l, params, tp)
        lv1 = sample_extract(acc, 0)
        return _tp_key_switch(lv1, ksk_l, params, tp)

    # KSK rows group as [N, t*base, cols]: shard the leading N-block axis.
    t_base = g.iks_t * (1 << g.basebit)
    ksk_blocked = ck.ksk_limbs.reshape(params.n1, t_base, -1)

    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(
            batch_spec(2),  # ct: [B, n0+1] over batch
            P(),  # testvec replicated
            P(None, MODEL_AXIS, None, None),  # bsk: 2L rows over model
            P(MODEL_AXIS, None, None),  # ksk: N blocks over model
        ),
        out_specs=batch_spec(2),
        check_vma=False,
    )

    tv = ck.testvec if testvec is None else testvec
    out = mapped(ct, tv, ck.bsk, ksk_blocked)
    return out


def tensor_parallel_lut_bootstrap(
    ct: jax.Array, f, message_modulus: int, ck: CloudKey, mesh: Mesh
) -> jax.Array:
    """Programmable bootstrap on the (batch, model) mesh: the LUT polynomial
    replaces the gate test vector; everything else shards as in
    tensor_parallel_bootstrap. The LUT builds once on the host."""
    from ..lut.generator import Generator

    lut = Generator(message_modulus, ck.params).generate_lookup_table(f)
    return tensor_parallel_bootstrap(ct, ck, mesh, testvec=lut.poly)


@partial(jax.jit, static_argnames=("name", "mesh", "impl"))
def _tp_gate(name: str, a, b, ck: CloudKey, mesh: Mesh, impl: str = "auto"):
    del impl  # jit cache key for config.step_impl (see gates._gate2)
    lin = _LINEAR_FORMS[name](a, b)
    return tensor_parallel_bootstrap(lin, ck, mesh)


def tensor_parallel_gate(name, a, b, ck: CloudKey, mesh: Mesh):
    """Gate evaluation on the (batch, model) mesh: linear form then TP
    bootstrap. a, b: uint32 [B, n0+1] with B divisible by the batch size."""
    from ..config import config

    return _tp_gate(name, a, b, ck, mesh, config.step_impl)
