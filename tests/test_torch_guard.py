"""The port's import boundary and device contract: ``repro_torch`` loads
with JAX blocked and pulls in nothing of ``repro``, and its entry points
refuse to run when the card is asked for (the default) but absent."""

import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the port's examples: they import only repro_torch, numpy and the
# standard library
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def test_every_module_imports_without_jax_or_repro():
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any `import jax` now raises
        sys.modules["ml_dtypes"] = None  # a JAX dependency: blocked as well
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import importlib.util, pathlib
        for path in sorted(pathlib.Path("examples").glob("torch_*.py")):
            spec = importlib.util.spec_from_file_location(path.stem, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = sorted(
            m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        slice_2 = {"repro_torch.kernels.autotune", "repro_torch.kernels.xor_parity",
                   "repro_torch.gateway.sharding"}
        assert slice_2 <= set(names), slice_2 - set(names)
        slice_3 = {"repro_torch.configs", "repro_torch.configs.falcon_mamba_7b",
                   "repro_torch.kernels.selective_scan", "repro_torch.models.mamba",
                   "repro_torch.models.convert", "repro_torch.models.registry",
                   "repro_torch.serve.kvcache", "repro_torch.serve.serve_step",
                   "repro_torch.launch.serve"}
        assert slice_3 <= set(names), slice_3 - set(names)
        slice_6 = {"repro_torch.scenario", "repro_torch.scenario.trace",
                   "repro_torch.scenario.engine", "repro_torch.core.analysis",
                   "repro_torch.checkpoint", "repro_torch.checkpoint.partition",
                   "repro_torch.checkpoint.core_ckpt"}
        assert slice_6 <= set(names), slice_6 - set(names)
        slice_7 = {"repro_torch.train", "repro_torch.train.optimizer",
                   "repro_torch.train.train_step", "repro_torch.train.elastic",
                   "repro_torch.train.loop", "repro_torch.data", "repro_torch.data.pipeline",
                   "repro_torch.models.transformer", "repro_torch.launch.train"}
        assert slice_7 <= set(names), slice_7 - set(names)
        slice_8 = {"repro_torch.configs." + arch for arch in (
            "qwen2_72b", "mistral_large_123b", "starcoder2_15b", "command_r_35b",
            "pixtral_12b")}
        assert slice_8 <= set(names), slice_8 - set(names)
        slice_9 = {"repro_torch.models.moe", "repro_torch.configs.olmoe_1b_7b",
                   "repro_torch.configs.granite_moe_3b_a800m"}
        assert slice_9 <= set(names), slice_9 - set(names)
        slice_12 = {"repro_torch.analysis", "repro_torch.analysis.hlo_cost",
                    "repro_torch.analysis.roofline", "repro_torch.launch.mesh",
                    "repro_torch.core.distributed"}
        assert slice_12 <= set(names), slice_12 - set(names)
        slice_13 = {"repro_torch.launch.specs", "repro_torch.launch.dryrun"}
        assert slice_13 <= set(names), slice_13 - set(names)
        print(len(names))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 79  # every subpackage was walked


def test_no_jax_or_repro_import_lines():
    pattern = re.compile(r"^\s*(import|from) (jax|repro|ml_dtypes)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += EXAMPLES
    hits = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in files
        for m in pattern.finditer(p.read_text())
    ]
    assert not hits, hits


def _entry_points():
    from repro_torch.checkpoint import CoreCheckpointer
    from repro_torch.core.product_code import CoreCode, CoreCodec
    from repro_torch.gateway import DecodeCoalescer, GatewayConfig, ObjectGateway
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.storage.blockstore import BlockStore
    from repro_torch.storage.netmodel import ClusterProfile
    from repro_torch.storage.repair import BlockFixer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import mesh, serve, train
    from repro_torch.models import mamba, transformer
    from repro_torch.models.registry import get_model
    from repro_torch.train import optimizer, train_step
    from repro_torch.train.loop import LoopConfig, Trainer

    code = CoreCode(9, 6, 3)
    cfg = get_config("falcon_mamba_7b").reduced()
    dense = get_config("starcoder2_15b").reduced()
    moe_cfg = get_config("olmoe_1b_7b").reduced()
    hybrid = get_config("recurrentgemma_9b").reduced()
    encdec_cfg = get_config("seamless_m4t_large_v2").reduced()
    objs = np.zeros((3, 6, 16), dtype=np.uint8)
    return {
        "resolve_device": lambda: resolve_device(None),
        "resolve_cuda": lambda: resolve_device("cuda"),
        "codec": lambda: CoreCodec(code).encode(objs),
        "coalescer": lambda: DecodeCoalescer(),
        "fixer": lambda: BlockFixer(
            BlockStore(num_nodes=60), code, ClusterProfile.network_critical()
        ),
        "checkpointer": lambda: CoreCheckpointer(BlockStore(num_nodes=60), code),
        "gateway": lambda: ObjectGateway(
            code, ClusterProfile.network_critical(), 60, GatewayConfig()
        ),
        "mamba_lm": lambda: mamba.MambaLM(cfg),
        "init_lm": lambda: mamba.init_lm(cfg, 0),
        "init_cache": lambda: mamba.init_cache(cfg, 2),
        "launch_serve": lambda: serve.main(["--arch", "falcon_mamba_7b", "--reduced"]),
        "device_batch": lambda: SyntheticPipeline(cfg, 16, 2).device_batch(0),
        "init_state": lambda: train_step.init_state(cfg, get_model(cfg), 0,
                                                    optimizer.OptConfig()),
        "trainer": lambda: Trainer(cfg, LoopConfig()),
        "launch_train": lambda: train.main(["--arch", "falcon_mamba_7b", "--reduced",
                                            "--steps", "1"]),
        "transformer_lm": lambda: transformer.TransformerLM(dense),
        "dense_init_cache": lambda: transformer.init_cache(dense, 2, 16),
        "dense_prefill": lambda: get_model(dense).prefill(
            get_model(dense).init(dense, 0), {"tokens": np.zeros((1, 4), np.int32)}, dense,
            None, 16),
        "launch_serve_dense": lambda: serve.main(["--arch", "starcoder2_15b", "--reduced"]),
        "moe_init": lambda: get_model(moe_cfg).init(moe_cfg, 0),
        "launch_serve_moe": lambda: serve.main(["--arch", "olmoe_1b_7b", "--reduced"]),
        "trainer_dense": lambda: Trainer(dense, LoopConfig()),
        "launch_train_moe": lambda: train.main(["--arch", "olmoe_1b_7b", "--reduced",
                                                "--steps", "1"]),
        "hybrid_init": lambda: get_model(hybrid).init(hybrid, 0),
        "hybrid_init_cache": lambda: get_model(hybrid).init_cache(hybrid, 2, 16),
        "encdec_init": lambda: get_model(encdec_cfg).init(encdec_cfg, 0),
        "encdec_init_cache": lambda: get_model(encdec_cfg).init_cache(encdec_cfg, 2, 16),
        "launch_serve_hybrid": lambda: serve.main(["--arch", "recurrentgemma_9b", "--reduced"]),
        "launch_train_encdec": lambda: train.main(["--arch", "seamless_m4t_large_v2",
                                                   "--reduced", "--steps", "1"]),
        "host_mesh": lambda: mesh.make_host_mesh(1, 1),
        "init_ranks": lambda: mesh.init_ranks(0, 1, "file:///nonexistent/rendezvous"),
    }


@pytest.mark.parametrize(
    "name", ["resolve_device", "resolve_cuda", "codec", "coalescer", "fixer", "checkpointer",
             "gateway", "mamba_lm", "init_lm", "init_cache", "launch_serve", "device_batch",
             "init_state", "trainer", "launch_train", "transformer_lm", "dense_init_cache",
             "dense_prefill", "launch_serve_dense", "moe_init",
             "launch_serve_moe", "trainer_dense", "launch_train_moe", "hybrid_init",
             "hybrid_init_cache", "encdec_init", "encdec_init_cache", "launch_serve_hybrid",
             "launch_train_encdec", "host_mesh", "init_ranks"]
)
def test_default_device_raises_without_cuda(name, monkeypatch):
    """No silent CPU fallback: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_degraded_read",
                                  "torch_repair_scheduling", "torch_train_tiny_lm",
                                  "torch_gateway_serving"])
def test_example_default_device_raises_without_cuda(name, monkeypatch):
    """Each torch example runs on the card unless ``--device cpu`` is
    given (tests/test_torch_examples*.py run them so): without a card its
    ``main`` raises before any work."""
    import importlib.util

    assert ROOT / "examples" / f"{name}.py" in EXAMPLES
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--device", "cuda"])


@pytest.mark.parametrize("arch", ["starcoder2_15b", "pixtral_12b"])
def test_training_a_dense_arch_waits_for_its_slice(arch):
    """Its slice has come: ``Trainer`` takes the dense and vlm ids (and
    every other family's, the hybrid and encdec ones last) on the CPU
    when asked, with their family's model; no family is left to refuse."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import LoopConfig, Trainer

    for name in (arch, "recurrentgemma_9b", "seamless_m4t_large_v2"):
        cfg = get_config(name).reduced()
        tr = Trainer(cfg, LoopConfig(), device="cpu")
        assert tr.api is get_model(cfg) and tr.dev == torch.device("cpu")


def test_no_private_torch_distributed_imports():
    """The port keeps to the public DTensor / DeviceMesh API, which the
    card's torch and this host's both have: no ``torch.distributed._*``."""
    pattern = re.compile(r"torch\.distributed\._\w+|from torch\.distributed import _\w+")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += EXAMPLES
    hits = [f"{p.relative_to(ROOT)}: {m.group(0)}" for p in files
            for m in pattern.finditer(p.read_text())]
    assert not hits, hits


def test_private_testing_module_only_in_the_dry_run():
    """``torch.testing._internal`` (the fake process group) is imported
    by ``launch/dryrun.py`` alone, inside the function that builds the
    fake world; nothing else of the port or the smoke names it."""
    pattern = re.compile(r"torch\.testing\._internal")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = {p.relative_to(ROOT).as_posix() for p in files if pattern.search(p.read_text())}
    assert hits == {"src/repro_torch/launch/dryrun.py"}, hits
    text = (ROOT / "src" / "repro_torch" / "launch" / "dryrun.py").read_text()
    imports = [line for line in text.splitlines()
               if re.match(r"\s*(from|import) torch\.testing", line)]
    assert imports and all(line.startswith("    ") for line in imports), imports
    body = text[text.index("def _fake_world"):]
    body = body[:body.index("\ndef ", 1)]
    assert all(line.strip() in body for line in imports)


@pytest.mark.parametrize("arch", ["qwen2_72b", "falcon_mamba_7b", "recurrentgemma_9b",
                                  "seamless_m4t_large_v2"])
def test_serve_entry_points_keep_inference_mode_without_a_mesh(arch):
    """The eight ``prefill`` / ``decode_step`` entry points (dense, ssm,
    hybrid, encdec) run under ``inference_mode`` with no mesh in context:
    their outputs are inference tensors, as the single-card serve loops
    had them. With a mesh in context ``layers.serving`` takes ``no_grad``
    instead (DTensor refuses inference tensors)."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE, ServePlan, use_mesh

    cfg = get_config(arch).reduced(num_layers=3 if arch.startswith("recurrent") else 2)
    api = get_model(cfg)
    model = api.init(cfg, 0, device="cpu")
    batch = SyntheticPipeline(cfg, 8, 2, 0).device_batch(0, "cpu")
    logits, cache = api.prefill(model, batch, cfg, SINGLE, 16)
    assert logits.is_inference()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    logits, cache = api.decode(model, tok, cache, 8, cfg, SINGLE, ServePlan())
    assert logits.is_inference()

    @L.serving
    def modes():
        return torch.is_inference_mode_enabled(), torch.is_grad_enabled()

    assert modes() == (True, False)
    with use_mesh(types.SimpleNamespace(mesh=torch.ones(1))):
        assert modes() == (False, False)


_DTENSOR_TO_WRAPPERS = """
import os, sys, tempfile
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.launch.mesh import init_ranks, make_mesh
import importlib
# the package __init__ re-exports the functions under the modules' names
gf, rd, re_, ss, xp = (importlib.import_module("repro_torch.kernels." + m) for m in (
    "gf256_matmul", "ragged_decode", "ragged_encode", "selective_scan", "xor_parity"))

with tempfile.TemporaryDirectory() as tmp:
    init_ranks(0, 1, "file://" + os.path.join(tmp, "rdv"), "cpu", 60)
    mesh = make_mesh((1,), ("data",), device="cpu")
    d = lambda t: distribute_tensor(t, mesh, [Replicate()])
    u8 = lambda *shape: torch.zeros(shape, dtype=torch.uint8)
    tiles, mc, planes, data = u8(2, 3, 16), u8(2, 3, 8), u8(2, 3, 8), u8(3, 64)
    f = torch.zeros((1, 2, 4, 4))
    calls = {
        "K1": lambda: rd.ragged_gf256_tiles(d(mc), tiles),
        "K2": lambda: rd.ragged_xor_tiles(d(tiles)),
        "K3": lambda: re_.ragged_gf256_encode_tiles(mc, d(tiles)),
        "K4": lambda: re_.ragged_xor_encode_tiles(d(tiles)),
        "K5": lambda: gf.gf256_matmul_planes(d(planes), data, block_n=64),
        "K6": lambda: gf.gf256_matmul_planes_batched(planes[None], d(data[None]), block_n=64),
        "K7": lambda: xp.xor_parity(d(data), block_n=64),
        "K7b": lambda: xp.xor_parity_batched(d(data[None]), block_n=64),
        "K8": lambda: ss.selective_scan(d(f), f, torch.zeros((1, 2, 4))),
        "K8 h0": lambda: ss.selective_scan(f, f, torch.zeros((1, 2, 4)), h0=d(f[:, 0])),
    }
    for name, call in calls.items():
        try:
            call()
        except TypeError as e:
            assert "DTensor" in str(e), (name, e)
        else:
            raise AssertionError(name + " took a DTensor")
    print("REFUSED", len(calls))
    dist.destroy_process_group()
"""


def test_kernel_wrappers_refuse_a_dtensor():
    """K1-K8 read raw pointers: a DTensor (one rank's shard) would be
    taken silently, so each wrapper raises TypeError; the call site
    unwraps shards through ``local_map``. One gloo rank in a subprocess."""
    proc = subprocess.run(
        [sys.executable, "-c", _DTENSOR_TO_WRAPPERS], capture_output=True, text=True,
        cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "REFUSED 10"


def test_mesh_launcher_wants_a_card_per_rank(monkeypatch):
    """NCCL takes one rank per card: two ranks on the card with one card
    raise ValueError before any rank is spawned."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per"):
        train.main(["--arch", "falcon_mamba_7b", "--reduced", "--devices", "2",
                    "--mesh", "1x2"])


def test_cpu_is_taken_only_when_asked():
    from repro_torch.kernels.backend import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A wrapper given a tensor that is not on the CPU launches its
    kernel or raises; it never quietly computes the plain version."""
    from repro_torch.kernels import _build, ragged_decode

    calls = []
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a[0]))
    meta = torch.zeros((4, 3, 128), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        ragged_decode.ragged_xor_tiles(meta)
    assert not calls


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_tracks_the_sources():
    from repro_torch.kernels import _build

    path = _build.library_path()
    assert path.parent == ROOT / "build" / "repro_torch"
    assert path.name.startswith("libragged_") and path.suffix == ".so"
    assert [p.name for p in _build.sources()] == [
        "gf_matmul_xor.cu", "ragged_tiles.cu", "selective_scan.cu"]


def test_selective_scan_takes_the_plain_path_only_on_the_cpu(monkeypatch):
    """K8: a CPU tensor runs ``selective_scan_plain``; a ``meta`` tensor
    (the dry run) gets empty outputs of the right shapes; any other
    device launches the kernel or raises, and never runs the plain
    version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ssk

    plain, launched = [], []
    real_plain = ssk.selective_scan_plain
    monkeypatch.setattr(ssk, "selective_scan_plain",
                        lambda *a: plain.append(a[0].device) or real_plain(*a))
    monkeypatch.setattr(_build, "launch", lambda *a: launched.append(a[0]))
    args = [torch.ones(1, 3, 4, 8), torch.zeros(1, 3, 4, 8), torch.ones(1, 3, 8)]
    y = ssk.selective_scan(*args)
    assert plain == [torch.device("cpu")] and not launched
    assert torch.allclose(y, torch.zeros(1, 3, 4))
    meta = [a.to("meta") for a in args]
    y, h = ssk.selective_scan(*meta, h0=torch.ones(1, 4, 8, device="meta"), return_state=True)
    assert (y.device.type, y.shape, h.shape) == ("meta", (1, 3, 4), (1, 4, 8))
    assert plain == [torch.device("cpu")] and not launched


# -- the tile kernels' launch path, driven without a card -------------------

class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself on ``cuda:0``: it drives the
    wrappers' CUDA path (checks, allocation, launch arguments) on a host
    without a card, with ``_build.launch`` or its bound entries faked."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_typed(t):
    return t.as_subclass(_CudaTyped)


class _FakeLib:
    """Stands in for the loaded CDLL: every entry returns ``rc`` and
    records its arguments in ``calls``, and each attribute lookup is
    counted."""

    def __init__(self, rc):
        self.rc, self.lookups, self.calls = rc, {}, []

    def __getattr__(self, name):
        self.lookups[name] = self.lookups.get(name, 0) + 1
        if name == "ragged_error_string":
            return lambda code: b"fake error"
        return lambda *args: self.calls.append((name, args)) or self.rc


@pytest.fixture
def fake_library(monkeypatch):
    """Load ``_FakeLib(rc)`` in place of the built library, with the
    current stream faked; returns a loader taking ``rc``."""
    from repro_torch.kernels import _build, ragged_decode, selective_scan

    monkeypatch.setattr(ragged_decode, "raw_stream", lambda device: 0)
    monkeypatch.setattr(selective_scan, "raw_stream", lambda device: 0)
    monkeypatch.setattr(_build, "build", lambda: ROOT / "build" / "fake.so")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_fns", None)

    def load(rc):
        lib = _FakeLib(rc)
        monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
        return lib

    return load


def _tile_operands(c=4, kk=3, tn=128):
    mc = _cuda_typed(torch.zeros((c, kk, 8), dtype=torch.uint8))
    return mc, _cuda_typed(torch.zeros((c, kk, tn), dtype=torch.uint8))


def test_entries_are_resolved_once(fake_library):
    """The C entries are looked up and typed when the library loads, not
    on each launch."""
    from repro_torch.kernels import _build, ops

    lib = fake_library(0)
    _build.reset_launches()
    mc, data = _tile_operands()
    for _ in range(3):
        ops.gf256_ragged(mc, data)
        ops.xor_ragged_encode(data)
    assert _build.LAUNCHES["ragged_gf256_tiles"] == 3
    assert _build.LAUNCHES["ragged_xor_encode_tiles"] == 3
    assert set(lib.lookups) >= set(_build.ENTRIES)
    assert all(n == 1 for n in lib.lookups.values()), lib.lookups


@pytest.mark.parametrize("name", ["ragged_gf256_tiles", "ragged_xor_tiles",
                                  "ragged_gf256_encode_tiles", "ragged_xor_encode_tiles"])
def test_refused_launch_raises_and_counts_nothing(name, fake_library):
    """A non-zero return of the C entry raises, naming the entry, and
    leaves the launch count where it was."""
    from repro_torch.kernels import _build, ops

    fake_library(700)
    _build.reset_launches()
    mc, data = _tile_operands()
    call = {
        "ragged_gf256_tiles": lambda: ops.gf256_ragged(mc, data),
        "ragged_xor_tiles": lambda: ops.xor_ragged(data),
        "ragged_gf256_encode_tiles": lambda: ops.gf256_ragged_encode(mc, data),
        "ragged_xor_encode_tiles": lambda: ops.xor_ragged_encode(data),
    }[name]
    with pytest.raises(RuntimeError, match=f"{name}: CUDA error 700 \\(fake error\\)"):
        call()
    assert all(n == 0 for n in _build.LAUNCHES.values())


def _bad_operands():
    """(what, mc, data, error pattern): each check of the tile launch path
    failing alone, on CUDA-typed tensors."""
    u8 = torch.uint8
    base = torch.zeros((4, 3, 128 + 16), dtype=u8)
    planes = torch.zeros((4 * 3 * 8 + 1,), dtype=u8)
    good_mc = _cuda_typed(torch.zeros((4, 3, 8), dtype=u8))
    return {
        "dtype": (good_mc, _cuda_typed(torch.zeros((4, 3, 128), dtype=torch.int32)), "uint8"),
        "rank": (good_mc, _cuda_typed(torch.zeros((4, 384), dtype=u8)), "uint8"),
        "mc shape": (_cuda_typed(torch.zeros((4, 2, 8), dtype=u8)),
                     _cuda_typed(torch.zeros((4, 3, 128), dtype=u8)), "mc must be"),
        "empty": (_cuda_typed(torch.zeros((0, 3, 8), dtype=u8)),
                  _cuda_typed(torch.zeros((0, 3, 128), dtype=u8)), "empty"),
        "mc device": (torch.zeros((4, 3, 8), dtype=u8),
                      _cuda_typed(torch.zeros((4, 3, 128), dtype=u8)), "mc on cpu"),
        "width": (good_mc, _cuda_typed(torch.zeros((4, 3, 100), dtype=u8)),
                  "not a multiple of 16"),
        "contiguity": (good_mc, _cuda_typed(base[:, :, :128]), "contiguous"),
        "data alignment": (good_mc, _cuda_typed(base.view(-1)[1 : 1 + 4 * 3 * 128].view(4, 3, 128)),
                           "16-byte aligned"),
        "mc alignment": (_cuda_typed(planes[1:].view(4, 3, 8)),
                         _cuda_typed(torch.zeros((4, 3, 128), dtype=u8)), "8-byte aligned"),
    }


@pytest.mark.parametrize("what", ["dtype", "rank", "mc shape", "empty", "mc device", "width",
                                  "contiguity", "data alignment", "mc alignment"])
def test_tile_launch_checks_raise(what, fake_library):
    """Every check of the tile launch path still raises ValueError for a
    CUDA tensor, before anything is launched."""
    from repro_torch.kernels import _build, ragged_decode, ragged_encode

    lib = fake_library(0)
    _build.reset_launches()
    mc, data, pattern = _bad_operands()[what]
    wrappers = [lambda: ragged_decode.ragged_gf256_tiles(mc, data),
                lambda: ragged_encode.ragged_gf256_encode_tiles(mc, data)]
    if what not in ("mc shape", "mc device", "mc alignment"):  # checks of the XOR kind too
        wrappers += [lambda: ragged_decode.ragged_xor_tiles(data),
                     lambda: ragged_encode.ragged_xor_encode_tiles(data)]
    for call in wrappers:
        with pytest.raises(ValueError, match=pattern):
            call()
    assert all(n == 0 for n in _build.LAUNCHES.values()) and not lib.lookups


# -- K8's launch path, driven without a card ---------------------------------

DECODE_STEP = (4, 1, 8192, 16)  # (B, S, D, N): the launcher's decode call at batch 4


def _scan_operands(b, s, d, n, offset=None):
    """CUDA-typed da, dbu, cm, h0; ``offset`` names one of da, dbu, h0
    to make a view that starts one float past a 16-byte boundary."""
    ops = {"da": (b, s, d, n), "dbu": (b, s, d, n), "cm": (b, s, n), "h0": (b, d, n)}
    out = {}
    for name, shape in ops.items():
        base = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.float32)
        flat = base[1:] if name == offset else base[:-1]
        out[name] = _cuda_typed(flat.view(shape))
    return out


@pytest.mark.parametrize("what", ["da", "dbu", "h0"])
def test_scan_misaligned_operand_raises(what, fake_library):
    """For N >= 4 the kernel reads da, dbu and h0 as float4: a view one
    float past a 16-byte boundary raises ValueError before any launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import selective_scan

    lib = fake_library(0)
    _build.reset_launches()
    t = _scan_operands(2, 1, 8, 16, offset=what)
    assert t[what].data_ptr() % 16 == 4 and t[what].is_contiguous()
    with pytest.raises(ValueError, match=f"{what} must be 16-byte aligned"):
        selective_scan(t["da"], t["dbu"], t["cm"], h0=t["h0"], return_state=True)
    assert all(n == 0 for n in _build.LAUNCHES.values()) and not lib.calls


@pytest.mark.parametrize("what", ["da", "dbu", "cm", "h0"])
@pytest.mark.parametrize("on", ["cuda", "cpu"])
def test_scan_refuses_an_operand_that_requires_grad(what, on, fake_library, monkeypatch):
    """K8 has no backward: under grad an operand that requires grad
    raises ValueError, on the card's launch path and on the CPU alike,
    before anything runs; with grad off, or with no operand requiring
    grad, the same call launches (or runs the plain version)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ssk

    lib = fake_library(0)
    _build.reset_launches()
    plain = []
    real_plain = ssk.selective_scan_plain
    monkeypatch.setattr(ssk, "selective_scan_plain", lambda *a: plain.append(1) or real_plain(*a))
    t = _scan_operands(*DECODE_STEP) if on == "cuda" else {
        k: v.as_subclass(torch.Tensor).clone() for k, v in _scan_operands(2, 3, 8, 4).items()}
    t[what].requires_grad_(True)

    def call():
        return ssk.selective_scan(t["da"], t["dbu"], t["cm"], h0=t["h0"], return_state=True)

    with pytest.raises(ValueError, match="no backward"):
        call()
    assert all(n == 0 for n in _build.LAUNCHES.values()) and not lib.calls and not plain
    with torch.no_grad():
        call()
    if on == "cuda":
        assert _build.LAUNCHES["selective_scan"] == 1 and len(lib.calls) == 1
    else:
        assert plain == [1] and not lib.calls


def test_scan_small_n_takes_any_alignment(fake_library):
    """N < 4 runs the ring body (S = 3 here), which copies 4 bytes at a
    time where a row is not 16-byte aligned: a da, dbu or h0 one float off
    a 16-byte boundary launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import selective_scan

    lib = fake_library(0)
    _build.reset_launches()
    for what in ("h0", "da", "dbu"):
        t = _scan_operands(2, 3, 8, 2, offset=what)
        selective_scan(t["da"], t["dbu"], t["cm"], h0=t["h0"])
    assert _build.LAUNCHES["selective_scan"] == 3 and len(lib.calls) == 3


def test_scan_refused_launch_raises_and_counts_nothing(fake_library):
    """A non-zero return of the ``selective_scan`` entry raises, naming
    it, and leaves the launch count where it was."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import selective_scan

    fake_library(700)
    _build.reset_launches()
    t = _scan_operands(*DECODE_STEP)
    with pytest.raises(RuntimeError, match="selective_scan: CUDA error 700 \\(fake error\\)"):
        selective_scan(t["da"], t["dbu"], t["cm"], h0=t["h0"], return_state=True)
    assert all(n == 0 for n in _build.LAUNCHES.values())


def test_scan_entry_is_resolved_once(fake_library):
    """Many K8 calls look the entry up once, when the library loads."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import selective_scan

    lib = fake_library(0)
    _build.reset_launches()
    t = _scan_operands(2, 1, 8, 16)
    for _ in range(5):
        selective_scan(t["da"], t["dbu"], t["cm"], h0=t["h0"], return_state=True)
    assert _build.LAUNCHES["selective_scan"] == 5 and len(lib.calls) == 5
    assert lib.lookups["selective_scan"] == 1, lib.lookups


@pytest.mark.parametrize("with_h0", [True, False])
def test_scan_decode_launch_arguments(with_h0, fake_library):
    """At the decode shape the wrapper passes the C entry its arguments
    in the order of ``_build.ENTRIES["selective_scan"]``: the six
    pointers (h0 and h_last null when absent), then B, S, D, N, the
    float4 body's plan (body, no stages, grid x) and the stream; y and
    h_last are the tensors it returns."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import BODY_VEC, scan_plan, selective_scan

    lib = fake_library(0)
    t = _scan_operands(*DECODE_STEP)
    h0 = t["h0"] if with_h0 else None
    y, h_last = selective_scan(t["da"], t["dbu"], t["cm"], h0=h0, return_state=True)
    y_only = selective_scan(t["da"], t["dbu"], t["cm"], h0=h0)
    (name, args), (_, args_y) = lib.calls
    assert name == "selective_scan" and len(args) == len(_build.ENTRIES[name])
    b, s, d, n = DECODE_STEP
    assert y.shape == (b, s, d) and h_last.shape == (b, d, n)
    assert y.dtype == h_last.dtype == torch.float32
    plan = scan_plan(b, s, d, n)
    assert plan.body == BODY_VEC
    assert args == (t["da"].data_ptr(), t["dbu"].data_ptr(), t["cm"].data_ptr(),
                    h0.data_ptr() if with_h0 else None, y.data_ptr(), h_last.data_ptr(),
                    b, s, d, n, BODY_VEC, 0, plan.grid[0], 0)
    assert args_y[5] is None and args_y[4] == y_only.data_ptr()


@pytest.mark.parametrize("shape", [(1, 2048, 4096, 1), (1, 32, 4096, 1), (4, 17, 200, 2),
                                   (1, 4099, 1000, 1), (2, 2, 1000, 1), (2, 1, 1000, 1),
                                   (4, 1, 4096, 2)])
def test_scan_ring_launch_arguments(shape, fake_library):
    """For N in {1, 2} the wrapper passes ``scan_plan``'s ring body to the
    C entry, at every S, in the order of ``_build.ENTRIES["selective_scan"]``:
    the six pointers, B, S, D, N, then the body, stages and grid x, then
    the stream; one launch, counted."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import BODY_RING, scan_plan, selective_scan

    lib = fake_library(0)
    _build.reset_launches()
    b, s, d, n = shape
    shapes = {"da": (b, s, d, n), "dbu": (b, s, d, n), "cm": (b, s, n), "h0": (b, d, n)}
    t = {name: _cuda_typed(torch.empty(shape)) for name, shape in shapes.items()}
    y, h_last = selective_scan(t["da"], t["dbu"], t["cm"], h0=t["h0"], return_state=True)
    [(name, args)] = lib.calls
    assert name == "selective_scan" and len(args) == len(_build.ENTRIES[name])
    plan = scan_plan(b, s, d, n)
    assert plan.body == BODY_RING
    assert args == (t["da"].data_ptr(), t["dbu"].data_ptr(), t["cm"].data_ptr(),
                    t["h0"].data_ptr(), y.data_ptr(), h_last.data_ptr(), b, s, d, n, BODY_RING,
                    plan.stages, plan.grid[0], 0)
    assert _build.LAUNCHES["selective_scan"] == 1

