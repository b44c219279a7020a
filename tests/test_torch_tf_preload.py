"""Crash guard for the reference suite: load TensorFlow before EGL.

TensorFlow, which ``torch.utils.tensorboard`` pulls in (as the JAX
package's TensorBoard logger does), segfaults in its CPU-feature guard when
a process first imports it after dm_control has loaded EGL
(``tests/test_envs/test_dmc.py``). Importing it here, at collection, before
any test runs, keeps a process or xdist worker that runs both kinds of test
alive. Collection imports this module whether or not ``-k`` selects its
test; a run restricted to other files loses the guard, so keep this file
in any subset that holds ``test_dmc.py`` and a TensorBoard-logger test.
"""

import importlib.util
import sys

import torch.utils.tensorboard  # noqa: F401


def test_tensorflow_is_loaded_at_collection():
    assert "torch.utils.tensorboard" in sys.modules
    # where TensorFlow is installed, tensorboard has loaded it by now
    assert "tensorflow" in sys.modules or importlib.util.find_spec("tensorflow") is None
