"""Homomorphic boolean gates, batch-first.

Every two-input gate is: a wrapping-uint32 linear combination of the input
batches plus a constant torus bias on the body, followed by one gate
bootstrap (reference gates.rs:54-218). All functions operate on ciphertext
*batches* uint32 [B, n0+1]; a single ciphertext is just B = 1. There is no
separate "batch_*" entry point as in the reference (gates.rs:352-547) — the
batch axis IS the parallelism, sharded across devices by parallel/.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import bootstrap as bs
from .config import config
from .key import CloudKey
from .ops.keyswitch import identity_key_switch
from .torus import f64_to_torus, neg_torus

_BIAS_1_8 = int(f64_to_torus(0.125))
_BIAS_M1_8 = int(f64_to_torus(-0.125))
_BIAS_1_4 = int(f64_to_torus(0.25))
_BIAS_M1_4 = int(f64_to_torus(-0.25))


def _lin(x):
    return x


def _neg(x):
    return neg_torus(x)


def _biased(ct, bias: int):
    return ct.at[..., -1].add(jnp.uint32(bias & 0xFFFFFFFF))


# ---------------------------------------------------------------------------
# Gate linear forms (reference gates.rs equations)
# ---------------------------------------------------------------------------

def _nand_lin(a, b):
    return _biased(_neg(a + b), _BIAS_1_8)  # gates.rs:54-58


def _or_lin(a, b):
    return _biased(a + b, _BIAS_1_8)  # gates.rs:62-66


def _and_lin(a, b):
    return _biased(a + b, _BIAS_M1_8)  # gates.rs:70-74


def _xor_lin(a, b):
    return _biased(a + b * jnp.uint32(2), _BIAS_1_4)  # gates.rs:78-82


def _xnor_lin(a, b):
    # XNOR = -2(a+b) - 1/4. NOTE: the reference's xnor (gates.rs:86-90,
    # a - 2b - 1/4) actually evaluates XOR — its own test expects `a ^ b`
    # (gates.rs:575-580). We implement true XNOR.
    return _biased(_neg(a + b) * jnp.uint32(2), _BIAS_M1_4)


def _nor_lin(a, b):
    return _biased(_neg(a + b), _BIAS_M1_8)  # gates.rs:94-98


def _and_ny_lin(a, b):
    return _biased(_neg(a) + b, _BIAS_M1_8)  # gates.rs:102-111 ((not a) and b)


def _and_yn_lin(a, b):
    return _biased(a - b, _BIAS_M1_8)  # gates.rs:115-124 (a and (not b))


def _or_ny_lin(a, b):
    return _biased(_neg(a) + b, _BIAS_1_8)  # gates.rs:128-137 ((not a) or b)


def _or_yn_lin(a, b):
    return _biased(a - b, _BIAS_1_8)  # gates.rs:141-150 (a or (not b))


_LINEAR_FORMS = {
    "nand": _nand_lin,
    "or": _or_lin,
    "and": _and_lin,
    "xor": _xor_lin,
    "xnor": _xnor_lin,
    "nor": _nor_lin,
    "and_ny": _and_ny_lin,
    "and_yn": _and_yn_lin,
    "or_ny": _or_ny_lin,
    "or_yn": _or_yn_lin,
}


# ---------------------------------------------------------------------------
# Jitted gate implementations
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("name", "impl"))
def _gate2(
    name: str, a: jax.Array, b: jax.Array, ck: CloudKey, impl: str = "auto"
) -> jax.Array:
    # `impl` mirrors config.step_impl purely to key the jit cache: the config
    # is read at trace time inside blind_rotate, so without it a config
    # change after the first trace would silently reuse the old executable.
    del impl
    return bs.bootstrap(_LINEAR_FORMS[name](a, b), ck)


@partial(jax.jit, static_argnames=("impl",))
def _mux_impl(
    a: jax.Array, b: jax.Array, c: jax.Array, ck: CloudKey, impl: str = "auto"
) -> jax.Array:
    """MUX(a; b, c) = a ? b : c with 2 blind rotations + 1 key switch.

    Deviation from the reference's mux (gates.rs:157-183): the reference runs
    a *third* bootstrap over truncated "hybrid" lv0 ciphertexts (an untested
    path relying on sample_extract_index_2's mask truncation, trlwe.rs:122-136).
    The standard TFHE MUX composes at lv1: u1 = BS(a and b), u2 = BS(!a and c)
    are fresh +/-1/8 encryptions, so u1 + u2 + 1/8 decides OR by sign without
    another bootstrap; one key switch returns to lv0.
    """
    u1 = bs.bootstrap_without_key_switch(_and_lin(a, b), ck)
    u2 = bs.bootstrap_without_key_switch(_and_lin(_neg(a), c), ck)
    u = _biased(u1 + u2, _BIAS_1_8)
    return identity_key_switch(u, ck.ksk_limbs, ck.params)


def nand(a, b, ck):
    return _gate2("nand", a, b, ck, config.step_impl)


def or_(a, b, ck):
    return _gate2("or", a, b, ck, config.step_impl)


def and_(a, b, ck):
    return _gate2("and", a, b, ck, config.step_impl)


def xor(a, b, ck):
    return _gate2("xor", a, b, ck, config.step_impl)


def xnor(a, b, ck):
    return _gate2("xnor", a, b, ck, config.step_impl)


def nor(a, b, ck):
    return _gate2("nor", a, b, ck, config.step_impl)


def and_ny(a, b, ck):
    return _gate2("and_ny", a, b, ck, config.step_impl)


def and_yn(a, b, ck):
    return _gate2("and_yn", a, b, ck, config.step_impl)


def or_ny(a, b, ck):
    return _gate2("or_ny", a, b, ck, config.step_impl)


def or_yn(a, b, ck):
    return _gate2("or_yn", a, b, ck, config.step_impl)


def mux(a, b, c, ck):
    return _mux_impl(a, b, c, ck, config.step_impl)


def mux_naive(a, b, c, ck):
    """3-gate MUX (reference gates.rs:189-199)."""
    return or_(and_(a, b, ck), and_(not_(a), c, ck), ck)


def not_(a):
    """Bootstrap-free NOT (reference gates.rs:202-204)."""
    return _neg(a)


def copy(a):
    return a


def constant(value, batch: int, params) -> jax.Array:
    """Trivial (noiseless) ciphertext of a constant (reference gates.rs:212-218).

    Replicates the reference's exact torus values: mu for true, 1 - mu for
    false (a 1-ulp quirk of gates.rs:214 kept for parity).
    """
    mu_true = jnp.uint32(_BIAS_1_8)
    mu_false = jnp.uint32((1 - _BIAS_1_8) & 0xFFFFFFFF)
    value = jnp.broadcast_to(jnp.asarray(value, dtype=bool), (batch,))
    ct = jnp.zeros((batch, params.n0 + 1), dtype=jnp.uint32)
    return ct.at[:, -1].set(jnp.where(value, mu_true, mu_false))


class Gates:
    """Gate API with an injectable bootstrap strategy (reference gates.rs:30-49).

    The default strategy uses the jitted fast paths above; injecting a custom
    strategy routes every gate through `strategy.bootstrap`.
    """

    def __init__(self, strategy=None):
        self._strategy = strategy

    @property
    def bootstrap_strategy(self) -> str:
        return self._strategy.name if self._strategy else "vanilla"

    def _run(self, name, a, b, ck):
        if self._strategy is None:
            return _gate2(name, a, b, ck, config.step_impl)
        # gate linear forms use the +/-1/8 boolean encoding — strategies
        # refresh them via bootstrap_gate (the generic bootstrap() may be
        # defined over message encodings instead, e.g. LutBootstrap)
        refresh = getattr(self._strategy, "bootstrap_gate", self._strategy.bootstrap)
        return refresh(_LINEAR_FORMS[name](a, b), ck)

    def nand(self, a, b, ck):
        return self._run("nand", a, b, ck)

    def or_(self, a, b, ck):
        return self._run("or", a, b, ck)

    def and_(self, a, b, ck):
        return self._run("and", a, b, ck)

    def xor(self, a, b, ck):
        return self._run("xor", a, b, ck)

    def xnor(self, a, b, ck):
        return self._run("xnor", a, b, ck)

    def nor(self, a, b, ck):
        return self._run("nor", a, b, ck)

    def and_ny(self, a, b, ck):
        return self._run("and_ny", a, b, ck)

    def and_yn(self, a, b, ck):
        return self._run("and_yn", a, b, ck)

    def or_ny(self, a, b, ck):
        return self._run("or_ny", a, b, ck)

    def or_yn(self, a, b, ck):
        return self._run("or_yn", a, b, ck)

    def mux(self, a, b, c, ck):
        if self._strategy is None:
            return mux(a, b, c, ck)
        # compose MUX from the injected strategy's primitives at lv1
        u1 = self._strategy.bootstrap_without_key_switch(_and_lin(a, b), ck)
        u2 = self._strategy.bootstrap_without_key_switch(_and_lin(_neg(a), c), ck)
        u = _biased(u1 + u2, _BIAS_1_8)
        return identity_key_switch(u, ck.ksk_limbs, ck.params)

    def mux_naive(self, a, b, c, ck):
        # route through the strategy-aware gates (reference gates.rs:189-199)
        return self.or_(self.and_(a, b, ck), self.and_(not_(a), c, ck), ck)

    def not_(self, a):
        return not_(a)

    def copy(self, a):
        return copy(a)

    def constant(self, value, batch, params):
        return constant(value, batch, params)


# Reference-style batch aliases: inputs are [(a, b), ...] stacks.
def batch_gate(name: str, a_batch, b_batch, ck):
    """Evaluate one gate over a whole batch in a single fused bootstrap scan
    (the analogue of reference batch_nand/batch_and/... gates.rs:352-547)."""
    return _gate2(name, a_batch, b_batch, ck, config.step_impl)
