"""The multi-rank evaluation twins at 4 gloo ranks: the checks of
``tests/torch_eval_twins.py`` (whose docstring states what each holds
and within which band); ``tests/test_torch_multiprocess.py`` runs them
at 2 ranks, with the fit half of ``tests/test_multiprocess.py``."""
import pytest

from torch_eval_twins import *  # noqa: F401,F403  (the twins, collected here)


@pytest.fixture(scope="module")
def world():
    return 4
