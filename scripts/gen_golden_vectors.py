"""Regenerate the golden vectors that pin bit-exact behaviour.

    python scripts/gen_golden_vectors.py               # tests/vectors/golden_tiny.npz (CPU)
    python scripts/gen_golden_vectors.py --production  # tests/vectors/golden_production.npz
    python scripts/gen_golden_vectors.py --production --out PATH

golden_tiny.npz: fixed-seed outputs of the full pipeline at TEST_TINY,
checked by tests/test_golden_vectors.py; written on the CPU, where TEST_TINY
compiles in seconds.

golden_production.npz: the production-parameter stages of
rs_tfhe_tpu/utils/golden.py, checked by chip_smoke.py. They run on the
default device (a GPU: the N=4096 stages are too large for a CPU run).

Run ONLY when an intentional numeric change lands: every server-side stage
is deterministic integer arithmetic given the jax.random seeds, so any
other drift is a bug.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "vectors",
                   "golden_tiny.npz")


def write_tiny():
    import jax.numpy as jnp

    from rs_tfhe_tpu import gates
    from rs_tfhe_tpu.bootstrap import LutBootstrap
    from rs_tfhe_tpu.key import CloudKey, SecretKey
    from rs_tfhe_tpu.ops.blind_rotate import blind_rotate
    from rs_tfhe_tpu.ops.extract import sample_extract
    from rs_tfhe_tpu.ops.keyswitch import identity_key_switch
    from rs_tfhe_tpu.params import TEST_TINY
    from rs_tfhe_tpu.tlwe import lwe_encrypt_bool, lwe_encrypt_message

    p = TEST_TINY
    sk = SecretKey.generate(jax.random.key(777), p)
    ck = CloudKey.generate(jax.random.key(778), sk)

    bits = jnp.asarray([True, False, True, True, False, False, True, False])
    a = lwe_encrypt_bool(jax.random.key(779), sk.lv0, bits, p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(780), sk.lv0, ~bits, p.tlwe_lv0.alpha)

    lin = gates._nand_lin(a, b)
    acc = blind_rotate(lin, ck.testvec, ck.bsk, p)
    lv1 = sample_extract(acc)
    ks = identity_key_switch(lv1, ck.ksk_limbs, p)
    nand = gates.nand(a, b, ck)
    mux = gates.mux(a, b, a, ck)

    msgs = jnp.asarray([0, 1, 2, 3, 4, 5, 6, 7], jnp.uint32)
    ct_m = lwe_encrypt_message(jax.random.key(781), sk.lv0, msgs, 8,
                               p.tlwe_lv0.alpha)
    pbs = LutBootstrap().bootstrap_func(ct_m, lambda v: (v * 5 + 1) % 8, 8, ck)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT,
        sk_lv0=np.asarray(sk.lv0),
        sk_lv1=np.asarray(sk.lv1),
        bsk_row0=np.asarray(ck.bsk[0]),
        ksk_limbs_head=np.asarray(ck.ksk_limbs[:64]),
        ct_a=np.asarray(a),
        blind_rotate_out=np.asarray(acc),
        extract_out=np.asarray(lv1),
        keyswitch_out=np.asarray(ks),
        nand_out=np.asarray(nand),
        mux_out=np.asarray(mux),
        pbs_out=np.asarray(pbs),
    )
    return OUT


def write_production(path):
    from rs_tfhe_tpu.utils import golden
    from rs_tfhe_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    arrays = {}
    for group, run in golden.GROUPS.items():
        sampled, stages = run()
        arrays[golden.digest_key(group)] = sampled
        for st in stages:
            if not st.correct:
                raise SystemExit(f"{st.name} does not decrypt correctly")
            arrays[st.name] = st.out
    np.savez_compressed(path, **arrays)
    return path


def main():
    if "--production" in sys.argv:
        from rs_tfhe_tpu.utils.golden import GOLDEN_PATH

        i = sys.argv.index("--out") + 1 if "--out" in sys.argv else 0
        path = write_production(sys.argv[i] if i else GOLDEN_PATH)
    else:
        jax.config.update("jax_platforms", "cpu")
        path = write_tiny()
    print(f"wrote {path}")
    for k, v in np.load(path).items():
        print(f"  {k}: {v.shape} {v.dtype}")


if __name__ == "__main__":
    main()
