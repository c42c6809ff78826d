"""The 48-plane AlphaGo feature encoding on tensors.

* :class:`~.api.Preprocess` -- batched encoder (``state_to_tensor``,
  ``states_to_tensor``, ``output_dim``), NHWC float32 like the
  reference;
* :data:`DEFAULT_FEATURES` / :data:`FEATURE_PLANES` -- the feature-name
  ⇄ plane-count contract shared with saved model specs.
"""

from rocalphago_tpu_torch.features.api import Preprocess  # noqa: F401
from rocalphago_tpu_torch.features.pyfeatures import (  # noqa: F401
    DEFAULT_FEATURES,
    FEATURE_PLANES,
    LADDER_FEATURES,
    VALUE_FEATURES,
    output_planes,
)
