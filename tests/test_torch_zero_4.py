"""The ZeRO twins at 4 gloo ranks against the JAX package on 4 of its
CPU devices: the checks of ``tests/torch_zero_twins.py`` (whose
docstring states what each holds and within which band), with a
``{"data": 4}`` mesh; ``tests/test_torch_zero.py`` runs them at 2 ranks,
with the graph under the wrapper."""
import pytest

from torch_zero_twins import *  # noqa: F401,F403  (the twins, collected here)


@pytest.fixture(scope="module")
def world():
    return 4
