"""rs_tfhe_tpu — a TFHE (gate bootstrapping) framework in JAX.

Built from scratch in JAX/XLA with the capabilities of
thedonutfactory/rs-tfhe, re-designed batch-first for accelerators: the
negacyclic polynomial arithmetic at the heart of the external product runs as
integer-exact int8 limb matmuls, blind rotation is a `lax.scan` whose
every step processes the whole ciphertext batch, and batches shard across
device meshes via `shard_map`.
"""

__version__ = "0.4.0"

from .params import (  # noqa: F401
    ALL_SECURITY_SETS,
    DEFAULT_SECURITY,
    SECURITY_80_BIT,
    SECURITY_110_BIT,
    SECURITY_128_BIT,
    SECURITY_128_BIT_FAST,
    SECURITY_128_BIT_NIBBLE,
    SECURITY_128_BIT_RADIX,
    SECURITY_UINT1,
    SECURITY_UINT2,
    SECURITY_UINT3,
    SECURITY_UINT4,
    SECURITY_UINT5,
    SECURITY_UINT6,
    SECURITY_UINT7,
    SECURITY_UINT8,
    TEST_TINY,
    TfheParams,
    security_info,
)

from . import bit_utils, bootstrap, gates, lut, models, parallel, proxy_reenc  # noqa: F401,E402
from . import tlwe, trgsw, trlwe, utils  # noqa: F401,E402
from .bootstrap import LutBootstrap, VanillaBootstrap, default_bootstrap  # noqa: F401,E402
from .fhe import FheBool, FheInt, FheUint, FheUintRadix  # noqa: F401,E402
from .gates import Gates  # noqa: F401,E402
from .key import CloudKey, SecretKey  # noqa: F401,E402
