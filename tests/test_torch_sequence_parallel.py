"""The sequence-parallel slice at 2 gloo ranks against the JAX package
on 2 of its CPU devices: the twins of ``tests/torch_sp_twins.py``
(whose docstring states what each holds and within which band), with a
``{"seq": 2}`` mesh; ``tests/test_torch_sequence_parallel_4.py`` runs them at
4 ranks."""
import pytest

from torch_sp_twins import *  # noqa: F401,F403  (the twins, collected here)


@pytest.fixture(scope="module")
def world():
    return 2
