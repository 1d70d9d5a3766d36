"""The port stands alone: no module of paddle_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; and its entry points run on
the card unless the caller asks for the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}


def _port_files():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) \
                and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    assert path.exists(), path
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom paddle_tpu.ops import x\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert {r for r, _ in _imported_roots(f)} & FORBIDDEN \
        == {"paddle_tpu", "jax"}


def test_engine_without_device_needs_a_card(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference.paged import ServingEngine
    from paddle_tpu_torch.models.llama import (init_llama_params,
                                               llama_config_tiny)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_config_tiny(vocab=64, hidden=32, layers=1, heads=2, seq=32)
    params = init_llama_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_functions_without_device_need_a_card(monkeypatch):
    """init_llama_params and build_llama_paged_decode resolve device=None
    to the card too, and run on the CPU only when asked."""
    from paddle_tpu_torch.models.llama import (build_llama_paged_decode,
                                               init_llama_params,
                                               llama_config_tiny)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_config_tiny(vocab=64, hidden=32, layers=1, heads=2, seq=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_llama_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_llama_paged_decode(cfg, page_size=4, num_pages=4)
    params = init_llama_params(cfg, device="cpu")
    assert params[0]["tok"].device == torch.device("cpu")
    init_pages, *_ = build_llama_paged_decode(cfg, page_size=4, num_pages=4,
                                              device="cpu")
    assert init_pages()["k"].device == torch.device("cpu")


def test_params_from_numpy_without_device_needs_a_card(monkeypatch):
    """``params_from_numpy`` resolves device=None to the card, as its ERNIE
    sibling does, and lands on the CPU only when asked."""
    from paddle_tpu_torch.models.convert import params_from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trees = ({"tok": np.zeros((4, 2), np.float32)},
             {"wq": np.zeros((1, 2, 2), np.float32)},
             {"lm": np.zeros((2, 4), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(*trees)
    ep, bp, hp = params_from_numpy(*trees, device="cpu")
    assert {t.device for t in (ep["tok"], bp["wq"], hp["lm"])} \
        == {torch.device("cpu")}


def test_train_entry_points_without_device_need_a_card(monkeypatch):
    """build_functional_llama and the optimizer's init_opt_state resolve
    device=None to the card too, and run on the CPU only when asked."""
    from paddle_tpu_torch.models.llama import (build_functional_llama,
                                               llama_config_tiny)
    from paddle_tpu_torch.optimizer import AdamW
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_config_tiny(vocab=64, hidden=32, layers=1, heads=2, seq=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_functional_llama(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_functional_llama(cfg, init_params=False)
    ep, bp, hp, *_ = build_functional_llama(cfg, device="cpu")
    assert bp["wq"].device == torch.device("cpu")
    opt = AdamW()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.init_opt_state(hp)
    st = opt.init_opt_state(hp, device="cpu")
    assert st["lm"]["moment1"].device == torch.device("cpu")


def test_ernie_entry_points_without_device_need_a_card(monkeypatch):
    """The ERNIE constructors and ``ernie_params_from_numpy`` resolve
    device=None to the card, and run on the CPU only when asked."""
    from paddle_tpu_torch.models import (ErnieForMaskedLM,
                                         ErnieForSequenceClassification,
                                         ErnieModel, ernie_config_tiny,
                                         ernie_params_from_numpy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ernie_config_tiny(vocab=64, hidden=32, layers=1, heads=2, seq=16)
    for cls in (ErnieModel, ErnieForMaskedLM,
                ErnieForSequenceClassification):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(cfg)
        model = cls(cfg, device="cpu")
        assert {p.device for p in model.parameters()} == {torch.device("cpu")}
    named = {"w": np.zeros((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ernie_params_from_numpy(named)
    assert ernie_params_from_numpy(named, device="cpu")["w"].device \
        == torch.device("cpu")


def test_the_scan_covers_the_ernie_modules():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("models/ernie.py", "models/convert.py", "nn/layers.py",
                "nn/functional/activation.py", "nn/functional/attention.py",
                "nn/functional/norm.py"):
        assert f"paddle_tpu_torch/{mod}" in names


def test_the_scan_covers_the_train_modules():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("ops/flash_attention.py", "ops/fused.py",
                "optimizer/optimizers.py", "incubate/nn/functional.py",
                "parallel/pipeline.py"):
        assert f"paddle_tpu_torch/{mod}" in names


def test_the_scan_covers_the_dropout_modules():
    """The dropout slice's modules: the functional and the layer, the
    attention functionals with dropout, and the flash kernels' sources
    (a ``.cu`` / ``.cuh`` is not Python, so the scan reads the wrapper)."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("nn/functional/common.py", "nn/layers.py",
                "nn/functional/attention.py", "ops/flash_attention.py",
                "models/ernie.py"):
        assert f"paddle_tpu_torch/{mod}" in names
    assert (REPO / "paddle_tpu_torch/ops/csrc/philox.cuh").exists()


def test_vit_entry_points_without_device_need_a_card(monkeypatch):
    """The ViT constructors and ``vit_params_from_numpy`` resolve
    device=None to the card, and run on the CPU only when asked;
    ``flash_attn_unpadded`` runs where its tensors lie, and on CPU tensors
    launches no kernel."""
    from paddle_tpu_torch.models import vit_params_from_numpy
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle_tpu_torch.ops import flash_attention as tfa
    from paddle_tpu_torch.vision.models import (VisionTransformer, vit_b_16,
                                                vit_l_16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (vit_b_16, vit_l_16):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    tiny = dict(img_size=16, patch_size=8, embed_dim=32, depth=1,
                num_heads=1, num_classes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VisionTransformer(**tiny)
    model = VisionTransformer(**tiny, device="cpu")
    assert {p.device for p in model.parameters()} == {torch.device("cpu")}
    named = {"w": np.zeros((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vit_params_from_numpy(named)
    assert vit_params_from_numpy(named, device="cpu")["w"].device \
        == torch.device("cpu")
    x = torch.zeros((256, 2, 64))
    cu = torch.tensor([0, 100, 256])
    before = tfa.flash_attention_fwd.launches
    out, _ = flash_attn_unpadded(x, x, x, cu, cu, 156, 156)
    assert out.device == torch.device("cpu") and out.shape == x.shape
    assert tfa.flash_attention_fwd.launches == before


def test_the_scan_covers_the_vit_modules():
    """The ViT slice's modules: the vision package, the layers it adds and
    the varlen functional."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("vision/__init__.py", "vision/models/__init__.py",
                "vision/models/vit.py", "nn/layers.py",
                "nn/functional/attention.py", "models/convert.py"):
        assert f"paddle_tpu_torch/{mod}" in names


def test_unet_entry_points_without_device_need_a_card(monkeypatch):
    """The UNet constructor and ``unet_params_from_numpy`` resolve
    device=None to the card, and run on the CPU only when asked; the scan
    covers the UNet slice's modules, and every head width of the
    attention kernels has a library."""
    from paddle_tpu_torch.models import (UNet2DConditionModel,
                                         unet_config_tiny,
                                         unet_params_from_numpy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UNet2DConditionModel(unet_config_tiny())
    model = UNet2DConditionModel(unet_config_tiny(), device="cpu")
    assert {p.device for p in model.parameters()} == {torch.device("cpu")}
    named = {"w": np.zeros((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unet_params_from_numpy(named)
    assert unet_params_from_numpy(named, device="cpu")["w"].device \
        == torch.device("cpu")
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("models/unet.py", "nn/functional/norm.py",
                "nn/functional/common.py", "nn/functional/activation.py",
                "nn/layers.py"):
        assert f"paddle_tpu_torch/{mod}" in names
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as tpa
    from paddle_tpu_torch.ops.flash_attention import HEAD_WIDTHS
    libraries = _build._sources(REPO / "paddle_tpu_torch/ops/csrc")
    for w in HEAD_WIDTHS:
        assert _build.width_library("flash_attention", w) in libraries, w
    for d in range(8, 257, 8):
        for src in ("ragged_paged_attention", "ragged_paged_attention_quant"):
            assert _build.width_library(src, tpa.head_width(d)) in libraries


def test_vision_cnn_entry_points_without_device_need_a_card(monkeypatch):
    """The ResNet and MobileNet constructors, ``Momentum.init_opt_state``
    and ``vision_params_from_numpy`` resolve device=None to the card, and
    run on the CPU only when asked; the scan covers the slice's modules."""
    from paddle_tpu_torch.models import vision_params_from_numpy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as tvm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builds = [getattr(tvm, n) for n in (
        "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
        "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
        "resnext101_32x4d", "mobilenet_v1", "mobilenet_v2",
        "mobilenet_v3_small", "mobilenet_v3_large")]
    for build in builds:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(num_classes=3)
    for build in (tvm.resnet18, tvm.mobilenet_v3_small):
        model = build(num_classes=3, device="cpu")
        assert {t.device for t in model.state_dict().values()} \
            == {torch.device("cpu")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvm.ResNet(tvm.BasicBlock, 18)
    opt = Momentum()
    params = {"w": torch.zeros(2, 3)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.init_opt_state(params)
    st = opt.init_opt_state(params, device="cpu")
    assert st["w"]["velocity"].device == torch.device("cpu")
    named = {"w": np.zeros((2, 3), np.float32),
             "bn._mean": np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision_params_from_numpy(named)
    sd = vision_params_from_numpy(named, device="cpu", dtype=torch.bfloat16)
    assert {t.device for t in sd.values()} == {torch.device("cpu")}
    assert (sd["w"].dtype, sd["bn._mean"].dtype) \
        == (torch.bfloat16, torch.float32)
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("vision/models/resnet.py", "vision/models/mobilenet.py",
                "vision/models/__init__.py", "nn/functional/pooling.py",
                "nn/functional/norm.py", "nn/functional/activation.py",
                "nn/layers.py", "tensor/manipulation.py",
                "optimizer/optimizers.py", "models/convert.py"):
        assert f"paddle_tpu_torch/{mod}" in names


def test_the_scan_covers_the_train_loop_modules():
    """The train loop's exterior: the schedules, the clips and
    regularizers, the optimizer base, the scaler, the train telemetry,
    TrainStep, the checkpoint manager, the loss, io, metric, hapi,
    save / load, the datasets and the quantized parity harness."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("optimizer/lr.py", "optimizer/optimizers.py",
                "regularizer.py", "nn/clip.py", "nn/loss.py",
                "nn/functional/loss.py", "amp/grad_scaler.py",
                "observability/train.py", "parallel/train_step.py",
                "resilience/checkpoint.py", "io/__init__.py",
                "metric/__init__.py", "hapi/model.py", "hapi/callbacks.py",
                "framework.py", "vision/datasets.py", "serving/quant.py"):
        assert f"paddle_tpu_torch/{mod}" in names, mod


def test_train_loop_entry_points_without_device_need_a_card(monkeypatch):
    """``TrainStep``, ``hapi.Model`` and the optimizers' ``init_opt_state``
    resolve device=None to the card, and run on the CPU only when asked."""
    from torch import nn

    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
    from paddle_tpu_torch.parallel import TrainStep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = nn.Linear(3, 2)
    loss = lambda m, x: m(x).sum()  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainStep(net, Adam(0.1), loss)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(net)
    for opt in (Adam(), AdamW(), Momentum()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            opt.init_opt_state({"w": torch.zeros(2)})
    step = TrainStep(net, Adam(0.1), loss, device="cpu")
    assert step(np.ones((4, 3), np.float32)).device == torch.device("cpu")
    assert Model(net, device="cpu").device == torch.device("cpu")


def test_the_scan_covers_the_distributed_modules():
    """Distributed training: the environment, groups, collectives, the
    watchdog and the differentiated collectives, the mesh, the launcher,
    DataParallel, fleet and its tensor-parallel layers, eager ZeRO, the
    ZeRO step and the checkpoint at world N."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("distributed/__init__.py", "distributed/env.py",
                "distributed/utils.py", "distributed/topology.py",
                "distributed/parallel.py",
                "distributed/communication/__init__.py",
                "distributed/communication/group.py",
                "distributed/communication/collectives.py",
                "distributed/communication/watchdog.py",
                "distributed/communication/differentiable.py",
                "distributed/communication/stream.py",
                "distributed/launch/main.py", "distributed/launch/__main__.py",
                "distributed/fleet/__init__.py",
                "distributed/fleet/fleet_api.py",
                "distributed/fleet/hybrid_optimizer.py",
                "distributed/fleet/base/distributed_strategy.py",
                "distributed/fleet/utils/hybrid_parallel_util.py",
                "distributed/fleet/meta_parallel/__init__.py",
                "distributed/fleet/meta_parallel/mp_layers.py",
                "distributed/sharding/__init__.py",
                "distributed/checkpoint/save_state_dict.py",
                "distributed/checkpoint/load_state_dict.py",
                "parallel/sharded.py", "models/llama.py"):
        assert f"paddle_tpu_torch/{mod}" in names, mod


def test_distributed_entry_points_without_device_need_a_card(monkeypatch):
    """``init_parallel_env`` and ``ShardedTrainStep`` resolve device=None to
    the card, and NCCL's backend is refused for the CPU; ``build_mesh``
    needs the environment first.  With ``device="cpu"`` a world of one
    rank runs them on gloo."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"w": torch.ones(4, 2)}
    loss = lambda p, batch: (batch[0] @ p["w"]).sum()  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_parallel_env()
    with pytest.raises(ValueError, match="gloo"):
        dist.init_parallel_env(device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        topology.build_mesh({"dp": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedTrainStep(None, loss, params, AdamW(0.1))
    try:
        assert dist.init_parallel_env(device="cpu") == torch.device("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = topology.build_mesh({"dp": 1, "mp": 1})
        assert mesh.mesh_dim_names == ("dp", "mp")
        step = ShardedTrainStep(mesh, loss, params, AdamW(0.1), stage=3,
                                device="cpu")
        assert step(np.ones((2, 4), np.float32)).device \
            == torch.device("cpu")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
