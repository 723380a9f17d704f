"""Precision policies, re-exported at their train-layer name.

The substance lives in :mod:`blendjax_torch.precision`, outside the train
package, because the models resolve their compute dtype from it and a
process that only builds a model should not import the train layer.
"""

from blendjax_torch.precision import (  # noqa: F401
    BF16_COMPUTE,
    BF16_GRADS,
    DEFAULT_POLICY,
    F32,
    POLICIES,
    PrecisionPolicy,
    __all__,
    cast_floating,
    default_compute_dtype,
    policy_value_and_grad,
    resolve_policy,
)
