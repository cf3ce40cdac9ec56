"""Arbitrary-netlist evaluation with the native circuit scheduler.

The reference evaluates its 16-bit adder one bootstrap at a time
(examples/add_two_numbers.rs:60-97). Here the same ripple-carry netlist is
compiled by the C++ scheduler (csrc/circuit_scheduler.cpp) into level-
ordered, gate-type-grouped batches — each group is ONE batched bootstrap —
and executed over encrypted inputs.

    python examples/circuit_scheduler.py --width 8 --x 173 --y 90
"""

import jax
import jax.numpy as jnp
import numpy as np
from _common import make_keys, parse_args, timed

from rs_tfhe_tpu import native
from rs_tfhe_tpu.bit_utils import encrypt_uint
from rs_tfhe_tpu.models import netlist as NL
from rs_tfhe_tpu.tlwe import lwe_decrypt_bool


def main():
    args = parse_args(__doc__, width=8, x=173, y=90)
    w = args.width
    sk, ck = make_keys(args.param_set)

    ckt, a_w, b_w, sum_w = NL.ripple_carry_adder(w)
    plan = NL.plan(ckt)
    backend = "C++ scheduler" if native.available() else "python fallback"
    print(f"{len(ckt.gates)} gates -> {plan.n_levels} levels, "
          f"{len(plan.groups)} batched calls ({backend})")

    mod = 1 << w
    enc_a = encrypt_uint(jax.random.key(1), sk.lv0, args.x % mod, w,
                         args.param_set.tlwe_lv0.alpha)
    enc_b = encrypt_uint(jax.random.key(2), sk.lv0, args.y % mod, w,
                         args.param_set.tlwe_lv0.alpha)
    inputs = jnp.concatenate([enc_a, enc_b], axis=0)

    wires = timed("scheduled evaluation", NL.evaluate, ckt, inputs, ck, plan)
    bits = np.asarray(lwe_decrypt_bool(wires[np.asarray(sum_w)], sk.lv0))
    got = sum(int(b) << i for i, b in enumerate(bits))
    print(f"{args.x % mod} + {args.y % mod} = {got} "
          f"(expect {(args.x + args.y) % mod})")
    assert got == (args.x + args.y) % mod

    # whole-plan jit: the entire group sequence as ONE device program
    # (gather/scatter indices static) instead of one dispatch per group
    run = NL.compile_circuit(ckt, plan)
    _ = run(inputs, ck)  # compile
    wires = timed("whole-plan jit (compile_circuit)", run, inputs, ck)
    bits = np.asarray(lwe_decrypt_bool(wires[np.asarray(sum_w)], sk.lv0))
    got = sum(int(b) << i for i, b in enumerate(bits))
    assert got == (args.x + args.y) % mod
    print("OK")


if __name__ == "__main__":
    main()
