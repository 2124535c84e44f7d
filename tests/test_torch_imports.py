"""The PyTorch port stands alone: no file of ``instantrestore_tpu_torch/``
nor ``chip_smoke.py`` imports JAX or anything of the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "instantrestore_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "instantrestore_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_the_rule_itself():
    assert _forbidden("jax.numpy") and _forbidden("instantrestore_tpu.ops.primitives")
    assert _forbidden("instantrestore_tpu")
    assert not _forbidden("instantrestore_tpu_torch.ops.primitives")
    assert not _forbidden("instantrestore_tpu_torch")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


NEW_MODULES = ("instantrestore_tpu_torch/data/transforms.py",
               "instantrestore_tpu_torch/inference/predictor.py",
               "instantrestore_tpu_torch/csrc/shared_flash_bound.cu")


def test_cold_slice_modules_are_covered():
    files = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert set(NEW_MODULES[:2]) <= files
    assert (ROOT / NEW_MODULES[2]).is_file()


def test_parity_cli_and_console_scripts_are_covered():
    """The parity CLI and the console entry points are port files the rule
    above reads (neither may import JAX to reach the JAX package's scripts)."""
    files = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"instantrestore_tpu_torch/cli/parity.py",
            "instantrestore_tpu_torch/_cli.py"} <= files


def test_every_kernel_source_is_in_the_checkout():
    """The list of ops/_build.py, its ctypes signatures and csrc/*.cu name the same
    nine kernels, the online-max family and the three flash-VJP kernels among
    them, and each source includes nothing but the shared tiles and the CUDA
    toolkit's headers."""
    from instantrestore_tpu_torch.ops import _build

    on_disk = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert set(_build.SOURCES) == set(_build.SIGNATURES) == on_disk
    assert {"flash_online", "shared_online", "shared_online_pair"} <= on_disk
    assert {"flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"} <= on_disk
    assert len(_build.SOURCES) == 9
    for path in sorted(_build.CSRC.glob("*.cu*")):
        includes = [ln.split()[1] for ln in path.read_text().splitlines()
                    if ln.startswith("#include")]
        assert includes and all(
            inc in ('"attn_wgmma.cuh"', '"attn_wgmma_d512.cuh"',
                    '"attn_wgmma_bwd.cuh"', '"attn_wgmma_bwd_d512.cuh"', "<cuda.h>",
                    "<cuda_bf16.h>", "<cuda_runtime.h>", "<stdint.h>")
            for inc in includes), (path.name, includes)


WGMMA_SOURCES = ("shared_online.cu", "shared_online_pair.cu", "attn_wgmma.cuh",
                 "shared_identity.cu", "shared_flash_bound.cu")


@pytest.mark.parametrize("name", WGMMA_SOURCES)
def test_online_shared_kernels_are_on_the_wgmma_tile(name):
    """The four shared kernels (online and bound) and their tile compute with
    wgmma.mma_async on tiles brought by TMA, and hold nothing of the mma.sync
    tile: no <mma.h>, no wmma fragment, no include of attn_tile.cuh."""
    from instantrestore_tpu_torch.ops import _build

    text = (_build.CSRC / name).read_text()
    assert "wgmma.mma_async" in text and "cp.async.bulk" in text, name
    for word in ("<mma.h>", "wmma::", '"attn_tile.cuh"'):
        assert word not in text, (name, word)
    if name.endswith(".cu"):
        assert '#include "attn_wgmma.cuh"' in text
    else:
        for word in ("mbarrier.try_wait.parity", "cp.async.bulk.tensor.2d", "__grid_constant__",
                     "CU_TENSOR_MAP_SWIZZLE_128B", "fence.proxy.async"):
            assert word in text, word


def test_the_mma_sync_forward_tile_is_gone():
    """attn_tile.cuh and flash_bwd_tile.cuh, the WMMA tiles of the first
    slices, went with their last users: no source names either, and the bf16
    helpers they held live only in attn_wgmma.cuh."""
    from instantrestore_tpu_torch.ops import _build

    for gone, word in (("attn_tile", "attn_tile"), ("flash_bwd_tile", "flash_bwd_tile.cuh")):
        assert not (_build.CSRC / f"{gone}.cuh").exists()
        for path in sorted(_build.CSRC.glob("*.cu*")):
            assert word not in path.read_text(), (path.name, word)
    holders = {p.name for p in _build.CSRC.glob("*.cu*")
               if "uint4 pack8(" in p.read_text() or "void unpack8(" in p.read_text()}
    assert holders == {"attn_wgmma.cuh"}


@pytest.mark.parametrize("name", ["flash_online.cu", "flash_fwd_lse.cu"])
def test_online_flash_kernels_are_on_the_wgmma_tiles_at_both_widths(name):
    """Rows 8 and 4 include only the two wgmma + TMA forward tiles and launch
    the online policy on each: the plain layout of attn_wgmma.cuh at d = 64,
    attn_wgmma_d512.cuh at d = 512."""
    from instantrestore_tpu_torch.ops import _build

    src = (_build.CSRC / name).read_text()
    includes = [ln.split()[1] for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ['"attn_wgmma.cuh"', '"attn_wgmma_d512.cuh"']
    assert "launch_flash<Policy::kOnline>" in src
    assert "launch_flash_d512<Policy::kOnline>" in src
    tile = (_build.CSRC / "attn_wgmma_d512.cuh").read_text()
    assert "P == Policy::kBound || P == Policy::kOnline" in tile
    assert "only Policy::kBound is instantiated" not in tile


@pytest.mark.parametrize("word", ["wmma::", "<mma.h>"])
def test_only_the_d512_backward_tile_holds_mma_sync(word):
    """Every source and tile, the d = 512 backward's too, is on wgmma: the
    WMMA API and its header appear in no source, and flash_bwd_tile.cuh is
    gone."""
    from instantrestore_tpu_torch.ops import _build

    holders = {p.name for p in _build.CSRC.glob("*.cu*") if word in p.read_text()}
    assert holders == set()
    assert not (_build.CSRC / "flash_bwd_tile.cuh").exists()


def test_flash_bound_is_on_the_wgmma_tiles():
    """flash_bound.cu runs the bound policy on the wgmma + TMA tiles: the
    plain layout of attn_wgmma.cuh at d = 64, attn_wgmma_d512.cuh at d = 512
    (its own products on the first header's PTX wrappers, its K/V tiles by
    TMA); nothing of the mma.sync tile."""
    from instantrestore_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_bound.cu").read_text()
    assert '#include "attn_wgmma.cuh"' in src and '#include "attn_wgmma_d512.cuh"' in src
    assert "launch_flash<Policy::kBound>" in src and "launch_flash_d512<Policy::kBound" in src
    tile = (_build.CSRC / "attn_wgmma_d512.cuh").read_text()
    assert '#include "attn_wgmma.cuh"' in tile
    for word in ("wgmma.mma_async", "tma_load_2d", "reg_inc", "__grid_constant__", "mbar_wait"):
        assert word in tile, word
    for text in (src, tile):
        for word in ("<mma.h>", "wmma::", '"attn_tile.cuh"'):
            assert word not in text, word


@pytest.mark.parametrize("name,launcher", [("flash_bwd_dq.cu", "launch_dq"),
                                           ("flash_bwd_dkv.cu", "launch_dkv")])
def test_backward_d64_is_on_the_wgmma_tile(name, launcher):
    """The two backward kernels launch the wgmma + TMA tiles: at d = 64 that
    of attn_wgmma_bwd.cuh, at d = 512 that of attn_wgmma_bwd_d512.cuh (both
    built on attn_wgmma.cuh's PTX wrappers: wgmma, TMA, mbarriers,
    setmaxnreg), which hold nothing of the mma.sync tile."""
    from instantrestore_tpu_torch.ops import _build

    src = (_build.CSRC / name).read_text()
    includes = [ln.split()[1] for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ['"attn_wgmma_bwd.cuh"', '"attn_wgmma_bwd_d512.cuh"']
    d64 = src[src.index("if (D == 64)"):src.index("if (D == 512")]
    assert f"irt::wgb::{launcher}(" in d64
    assert f"irt::wgb512::{launcher}(" in src[src.index("if (D == 512"):]
    for header, loads in (("attn_wgmma_bwd.cuh", "tma_load_3d"),
                          ("attn_wgmma_bwd_d512.cuh", "tma_load_2d")):
        tile = (_build.CSRC / header).read_text()
        assert '#include "attn_wgmma.cuh"' in tile
        for word in ("wgmma_m64n64k16<1, 1>", loads, "mbar_wait", "reg_inc",
                     "__grid_constant__", "bulk_load("):
            assert word in tile, (header, word)
        for word in ("<mma.h>", "wmma::", '"attn_tile.cuh"', '"flash_bwd_tile.cuh"'):
            assert word not in tile, (header, word)


TRAINING_MODULES = (
    "instantrestore_tpu_torch/ops/flash_vjp.py",
    "instantrestore_tpu_torch/configs/config.py",
    "instantrestore_tpu_torch/training/optim.py",
    "instantrestore_tpu_torch/training/train_step.py",
    "instantrestore_tpu_torch/training/losses/lpips.py",
    "instantrestore_tpu_torch/training/losses/ssim.py",
    "instantrestore_tpu_torch/training/losses/composite.py",
)


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_slice_modules_are_covered(module):
    """Each module of the training slice is among the files checked above and
    imports on a machine without a GPU, a CUDA compiler or Triton."""
    assert module in {str(p.relative_to(ROOT)) for p in PORT_FILES}
    name = module[:-3].replace("/", ".")
    code = (f"import sys; sys.modules['triton'] = None; import {name}; "
            "assert 'instantrestore_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_kernel_sources_call_no_library():
    """The hand-written kernels contain no call into cuBLAS, cuDNN, CUTLASS
    device kernels or a fused attention operator."""
    for path in sorted((ROOT / "instantrestore_tpu_torch" / "csrc").glob("*.cu*")):
        text = path.read_text().lower()
        for word in ("cublas", "cudnn", "cutlass", "scaled_dot_product", "torch/"):
            assert word not in text, (path.name, word)


def test_port_imports_without_pillow():
    """PIL is imported where images are read or written, never at module
    import: the card's machine does not promise Pillow."""
    code = ("import sys; sys.modules['PIL'] = None; "
            "import instantrestore_tpu_torch.inference.predictor, "
            "instantrestore_tpu_torch.inference.serving, instantrestore_tpu_torch.data.transforms")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


CHECKPOINT_MODULES = (
    "instantrestore_tpu_torch/utils/torch_convert.py",
    "instantrestore_tpu_torch/utils/safetensors.py",
    "instantrestore_tpu_torch/training/checkpoints.py",
    "instantrestore_tpu_torch/models/text_encoder.py",
    "instantrestore_tpu_torch/models/tokenizer.py",
    "instantrestore_tpu_torch/cli/infer.py",
    "instantrestore_tpu_torch/cli/serve.py",
)


@pytest.mark.parametrize("module", CHECKPOINT_MODULES)
def test_checkpoint_slice_modules_are_covered(module):
    """Each module of the checkpoint and entry-point slice is among the files
    checked above and imports without a GPU, a CUDA compiler or Triton."""
    assert module in {str(p.relative_to(ROOT)) for p in PORT_FILES}
    name = module[:-3].replace("/", ".")
    code = (f"import sys; sys.modules['triton'] = None; import {name}; "
            "assert 'instantrestore_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_entry_points_import_without_pillow_or_safetensors():
    """The card's machine promises neither Pillow nor the safetensors
    package: the CLIs import without both (the port reads .safetensors
    itself, and PIL only where PNGs are read or written)."""
    code = ("import sys; sys.modules['PIL'] = None; sys.modules['safetensors'] = None; "
            "import instantrestore_tpu_torch.cli.serve, instantrestore_tpu_torch.cli.infer, "
            "instantrestore_tpu_torch.training.checkpoints; "
            "assert 'instantrestore_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


LOSS_MODULES = (
    "instantrestore_tpu_torch/ops/dct_jpeg.py",
    "instantrestore_tpu_torch/ops/image_ops.py",
    "instantrestore_tpu_torch/training/losses/id_loss.py",
    "instantrestore_tpu_torch/training/losses/gan.py",
    "instantrestore_tpu_torch/training/losses/backbones.py",
    "instantrestore_tpu_torch/models/vit.py",
    "instantrestore_tpu_torch/models/swin.py",
    "instantrestore_tpu_torch/data/mtcnn.py",
    "instantrestore_tpu_torch/data/canonical_face.py",
)


@pytest.fixture(scope="module")
def loss_modules_imported():
    """The loss slice's modules imported in one fresh interpreter without
    Triton: the names of those that failed (none, if all went well)."""
    code = ("import importlib, sys; sys.modules['triton'] = None; bad = []\n"
            f"for name in {[m[:-3].replace('/', '.') for m in LOSS_MODULES]!r}:\n"
            "    try:\n        importlib.import_module(name)\n"
            "    except Exception as e:\n        bad.append(name)\n"
            "print(sorted(bad)); assert 'instantrestore_tpu' not in sys.modules")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300,
                         capture_output=True, text=True)
    return set(ast.literal_eval(run.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", LOSS_MODULES)
def test_loss_slice_modules_are_covered(module, loss_modules_imported):
    """Each module of the full generator loss (the ID, cycle and GAN terms
    and the networks and image ops they need) is among the files checked
    above and imports without a GPU, a CUDA compiler or Triton."""
    assert module in {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert module[:-3].replace("/", ".") not in loss_modules_imported


def test_face_modules_import_without_pillow():
    """MTCNN and the canonical-face crop import on a machine without Pillow
    (the card's machine does not promise it): PIL is imported only where
    an image is resized, and the cascade runs on arrays."""
    code = ("import sys; sys.modules['PIL'] = None; "
            "import numpy as np, torch; "
            "from instantrestore_tpu_torch.data import canonical_face, mtcnn; "
            "p = mtcnn.init_mtcnn_params(torch.Generator().manual_seed(0)); "
            "mtcnn.detect_faces(p, np.zeros((40, 40, 3), np.uint8)); "
            "assert 'instantrestore_tpu' not in sys.modules and 'PIL.Image' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


TRAINER_MODULES = (
    "instantrestore_tpu_torch/data/degradations.py",
    "instantrestore_tpu_torch/data/transforms.py",
    "instantrestore_tpu_torch/data/datasets.py",
    "instantrestore_tpu_torch/data/loader.py",
    "instantrestore_tpu_torch/training/logging_utils.py",
    "instantrestore_tpu_torch/training/coach.py",
    "instantrestore_tpu_torch/utils/vis.py",
    "instantrestore_tpu_torch/cli/train.py",
)


@pytest.fixture(scope="module")
def trainer_modules_imported():
    """The trainer slice's modules imported in one fresh interpreter without
    Triton, OpenCV, Pillow or yaml (the card's machine promises none of
    them): the names of those that failed (none, if all went well)."""
    code = ("import importlib, sys\n"
            "for m in ('triton', 'cv2', 'PIL', 'yaml'):\n    sys.modules[m] = None\n"
            "bad = []\n"
            f"for name in {[m[:-3].replace('/', '.') for m in TRAINER_MODULES]!r}:\n"
            "    try:\n        importlib.import_module(name)\n"
            "    except Exception as e:\n        bad.append(name)\n"
            "print(sorted(bad)); assert 'instantrestore_tpu' not in sys.modules")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300,
                         capture_output=True, text=True)
    return set(ast.literal_eval(run.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", TRAINER_MODULES)
def test_trainer_slice_modules_are_covered(module, trainer_modules_imported):
    """Each module of the trainer slice (data pipeline, Coach, logger,
    visualisation, train entry point) is among the files checked above and
    imports without a GPU, a CUDA compiler, Triton, OpenCV, Pillow or yaml."""
    assert module in {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert module[:-3].replace("/", ".") not in trainer_modules_imported


PARALLEL_MODULES = (
    "instantrestore_tpu_torch/parallel/__init__.py",
    "instantrestore_tpu_torch/parallel/distributed.py",
)


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_slice_modules_are_covered(module):
    """The multi-process and multi-device modules are among the files checked
    above and import in a fresh interpreter without a GPU or Triton, and
    with neither JAX nor the JAX package loaded after them."""
    assert module in {str(p.relative_to(ROOT)) for p in PORT_FILES}
    name = module[:-3].replace("/", ".").removesuffix(".__init__")
    code = (f"import sys; sys.modules['triton'] = None; import {name}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'instantrestore_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


SLICE16_MODULES = (
    "instantrestore_tpu_torch/inference/workers.py",
    "instantrestore_tpu_torch/models/lora.py",
    "instantrestore_tpu_torch/inference/predictor.py",
)


@pytest.mark.parametrize("module", SLICE16_MODULES)
def test_worker_and_option_modules_are_covered(module):
    """The serving workers' module and the modules of the three model
    options are among the files checked above and import in a fresh
    interpreter without a GPU or Triton, starting no process, and with
    neither JAX nor the JAX package loaded after them."""
    assert module in {str(p.relative_to(ROOT)) for p in PORT_FILES}
    name = module[:-3].replace("/", ".")
    code = (f"import sys, multiprocessing; sys.modules['triton'] = None; import {name}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'instantrestore_tpu')]; assert not bad, bad; "
            "assert not multiprocessing.active_children()")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


INT8_AND_TOOL_MODULES = (
    "instantrestore_tpu_torch/ops/primitives.py",
    "instantrestore_tpu_torch/convert.py",
    "instantrestore_tpu_torch/models/vae.py",
    "instantrestore_tpu_torch/models/unet.py",
    "instantrestore_tpu_torch/inference/serving.py",
    "instantrestore_tpu_torch/cli/serve.py",
    "instantrestore_tpu_torch/cli/evaluate.py",
    "instantrestore_tpu_torch/inference/demo.py",
    "instantrestore_tpu_torch/data/mask_utils.py",
    "instantrestore_tpu_torch/utils/profiling.py",
    "instantrestore_tpu_torch/utils/git_utils.py",
)


@pytest.fixture(scope="module")
def int8_and_tool_modules_imported():
    """The int8 serving slice's modules and the evaluate CLI, the demo and
    the small utilities, imported in one fresh interpreter without Triton,
    OpenCV, Pillow or gradio (the card's machine promises none of them):
    the names of those that failed (none, if all went well)."""
    code = ("import importlib, multiprocessing, sys\n"
            "for m in ('triton', 'cv2', 'PIL', 'gradio'):\n    sys.modules[m] = None\n"
            "bad = []\n"
            f"for name in {[m[:-3].replace('/', '.') for m in INT8_AND_TOOL_MODULES]!r}:\n"
            "    try:\n        importlib.import_module(name)\n"
            "    except Exception as e:\n        bad.append(name)\n"
            "print(sorted(bad)); assert not multiprocessing.active_children()\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'instantrestore_tpu')]")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300,
                         capture_output=True, text=True)
    return set(ast.literal_eval(run.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", INT8_AND_TOOL_MODULES)
def test_int8_and_tool_modules_are_covered(module, int8_and_tool_modules_imported):
    """Each module of this slice is among the files checked above and
    imports without a GPU, a CUDA compiler, Triton, OpenCV, Pillow or
    gradio, starting no process and loading neither JAX nor the JAX
    package."""
    assert module in {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert module[:-3].replace("/", ".") not in int8_and_tool_modules_imported
