"""Neural-network configuration, layers, updaters, constraints,
``MultiLayerNetwork`` and transfer learning (port); see ``layers``,
``config``, ``updaters``, ``weights``, ``constraints``, ``multilayer``
and ``transferlearning``."""
from deeplearning4j_tpu_torch.nn.config import (MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration, TransferLearning, TransferLearningHelper)

__all__ = [
    "NeuralNetConfiguration",
    "MultiLayerConfiguration",
    "MultiLayerNetwork",
    "FineTuneConfiguration",
    "TransferLearning",
    "TransferLearningHelper",
]
