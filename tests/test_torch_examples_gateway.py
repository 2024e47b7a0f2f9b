"""examples/torch_gateway_serving.py in each of its eight modes with
``--device cpu`` beside its reference twin on the JAX package: every
printed line that depends on no measured host time equal
(``torch_example_cases``): served and completed counts, the audits,
durability, wrong bytes served, repair traffic a block, overheads and
tolerances, the routing identity. ``--trace`` also writes each twin's
chrome-tracing JSON, which its own package's ``validate_file`` checks."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import torch_example_cases as E  # noqa: E402

MODES = ([], ["--tenants"], ["--scenario"], ["--graybox"], ["--bakeoff"], ["--writes"],
         ["--shards", "4"], ["--trace"])


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m[0].lstrip("-") if m else "default")
def test_gateway_mode_matches_its_twin(mode, tmp_path):
    args = list(mode)
    if mode == ["--trace"]:
        ref_args, args = args + [str(tmp_path / "ref.json")], args + [str(tmp_path / "torch.json")]
    else:
        ref_args = args
    ref = E.start_reference("gateway_serving", ref_args)
    got = E.run_torch("gateway_serving", args)
    out = E.finish(ref)
    E.assert_twins_agree(" ".join(["gateway_serving", *mode[:1]]), out, got)
    if not mode or mode == ["--trace"]:
        assert "served 1200/1200 requests" in got
    if mode == ["--trace"]:
        from repro.obs import validate_file as jax_validate
        from repro_torch.obs import validate_file

        assert validate_file(str(tmp_path / "torch.json")) > 0
        assert jax_validate(str(tmp_path / "ref.json")) > 0
