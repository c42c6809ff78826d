"""Networks, the JSON spec contract and the Flax weight reader.

Importing the package registers every network class for
``NeuralNetBase.load_model``.
"""

from rocalphago_tpu_torch.models.nn_util import NeuralNetBase  # noqa: F401
from rocalphago_tpu_torch.models.policy import CNNPolicy  # noqa: F401
