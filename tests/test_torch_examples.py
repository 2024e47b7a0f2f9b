"""The torch examples of the storage and training paths
(examples/torch_{quickstart,degraded_read,repair_scheduling,
train_tiny_lm}.py) with ``--device cpu`` beside their reference twins on
the JAX package: every printed line that depends on no measured host
time equal (``torch_example_cases``); the gateway example's modes are in
tests/test_torch_examples_gateway.py.

train_tiny_lm at ``--steps 12`` starts both twins from the same weights
(the JAX package's ``init_lm`` for seed 0, converted: the torch twin's
``Trainer.init_state`` is patched to return them) and holds the first
and the last loss of its 12 steps within the tolerance
tests/test_torch_train.py holds the train step to (rtol = atol = 1e-4);
the blocks made unavailable, fetched and repaired, the MB and ``== OK``
are lines held equal.
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_example_cases as E  # noqa: E402

STORAGE = ("quickstart", "degraded_read", "repair_scheduling")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Tiny ops: torch's thread pool costs more than it saves; and no
    autotune disk cache shared with the reference twin's process."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", STORAGE)
def test_storage_example_matches_its_twin(name):
    ref = E.start_reference(name, [])
    got = E.run_torch(name, [])
    out = E.finish(ref)
    E.assert_twins_agree(name, out, got)
    if name != "repair_scheduling":
        assert "verified=True" in got or "ok=True" in got
        assert "verified=False" not in got and "ok=False" not in got


def test_train_tiny_lm_matches_its_twin(monkeypatch):
    from repro.configs import get_config as jax_get_config
    from repro.models.registry import get_model as jax_get_model
    from repro.train.loop import Trainer as JTrainer
    from repro_torch.models import convert
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.loop import Trainer

    cfg_j = jax_get_config("qwen2_72b").reduced()
    tree = jax.tree.map(np.asarray, jax_get_model(cfg_j).init(cfg_j, jax.random.PRNGKey(0)))
    trainers = {}
    j_init = JTrainer.init_state

    def reference_init(self):
        trainers["ref"] = self
        return j_init(self)

    def converted_init(self):
        trainers["torch"] = self
        params = convert.from_jax(tree, self.cfg, device=self.dev, trainable=True)
        return ts.TrainState(params, opt.init_opt_state(convert.stacked_tree(params), self.oc),
                             torch.zeros((), dtype=torch.int32, device=self.dev))

    monkeypatch.setattr(JTrainer, "init_state", reference_init)
    monkeypatch.setattr(Trainer, "init_state", converted_init)
    args = ["--steps", "12"]
    got = E.run_torch("train_tiny_lm", args)
    ref_mod = E.load_example("train_tiny_lm")
    monkeypatch.setattr("sys.argv", ["train_tiny_lm.py", *args])
    with E.contextlib.redirect_stdout(E.io.StringIO()) as buf:
        ref_mod.main()
    E.assert_twins_agree("train_tiny_lm", buf.getvalue(), got)
    assert "== OK" in got
    for i in (0, 11):  # the first and the last loss of the 12 steps
        want = trainers["ref"].metrics_log[i]["loss"]
        np.testing.assert_allclose(trainers["torch"].metrics_log[i]["loss"], want,
                                   rtol=1e-4, atol=1e-4)
