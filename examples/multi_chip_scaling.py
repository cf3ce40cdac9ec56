"""Multi-chip gate evaluation: data-parallel and tensor-parallel
(the device-mesh replacement for the reference's Railgun thread-pool examples:
custom_railgun.rs, batch_gates_scaling.rs).

Runs on real chips, or on a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multi_chip_scaling.py --cpu
"""

import jax
import jax.numpy as jnp
import numpy as np
from _common import make_keys, parse_args, timed

from rs_tfhe_tpu.parallel import data_parallel_gate, make_mesh, tensor_parallel_gate
from rs_tfhe_tpu.tlwe import lwe_decrypt_bool, lwe_encrypt_bool


def main():
    args = parse_args(__doc__, batch=32)
    sk, ck = make_keys(args.param_set)
    alpha = args.param_set.tlwe_lv0.alpha
    n_dev = len(jax.devices())
    print(f"{n_dev} device(s): {jax.devices()[0].platform}")

    rng = np.random.default_rng(0)
    bits_a = rng.integers(0, 2, args.batch).astype(bool)
    bits_b = rng.integers(0, 2, args.batch).astype(bool)
    ka, kb = jax.random.split(jax.random.key(3))
    a = lwe_encrypt_bool(ka, sk.lv0, jnp.asarray(bits_a), alpha)
    b = lwe_encrypt_bool(kb, sk.lv0, jnp.asarray(bits_b), alpha)

    mesh = make_mesh(n_dev)
    out = timed(f"data-parallel NAND over {n_dev} devices",
                data_parallel_gate, "nand", a, b, ck, mesh)
    assert (np.asarray(lwe_decrypt_bool(out, sk.lv0)) == ~(bits_a & bits_b)).all()

    if n_dev % 2 == 0 and (2 * args.param_set.trgsw_lv1.l) % 2 == 0:
        mesh_tp = make_mesh(n_dev, tp=2)
        out = timed(f"tensor-parallel NAND ({n_dev // 2} x 2 mesh)",
                    tensor_parallel_gate, "nand", a, b, ck, mesh_tp)
        assert (np.asarray(lwe_decrypt_bool(out, sk.lv0)) == ~(bits_a & bits_b)).all()
    print("OK")


if __name__ == "__main__":
    main()
