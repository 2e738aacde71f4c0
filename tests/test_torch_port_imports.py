"""The PyTorch port imports neither JAX/flax/optax nor the JAX package or
tools, nor OpenCV (cv2) nor PIL: it needs only PyTorch and numpy (the
card's machine has neither cv2 nor PIL; images are read by the port's own
decoder).

Runs in a subprocess, because this test process has already imported jax
(tests/conftest.py): a meta-path finder there refuses jax, flax, optax,
unicorn_tpu, tools, cv2 and PIL, then every module of unicorn_torch is
imported,
the training sub-packages `losses` (with the mask stage's `losses.mask`
and `losses.boxinst`) and `core`, the fused block op, the
device tracker, the streaming, inst and VOS drivers, the omni MOT driver,
the QDTrack / SORT / DeepSORT / MOTDT trackers and utils.boxes among them,
and the training loop's checkpoints, trainer, logger, meters and host data
path (preproc, transforms, the omni datasets, the loaders), the image
reader, the on-disk datasets and the RLE codec, the mosaic augmentation,
the dataset converters, the ResNet-50 and Swin trunks, the exp loader and
every exp copy, the evaluators with their native codecs' bindings and the
eval tool, the SOT / VOS benchmark harness with the test and analysis
tools, the host utils (setup_env, label_ops, model_utils, profiling), the
cv2-free drawing (visualize, debug_dump, demo_utils) and the model tools
(track, track_omni, demo, train, launch_uni, interpolation,
export_model), and data parallelism (parallel.mesh, parallel.multihost)
with the sequence-parallel driver and runners, and the frame split over
ranks by rows (parallel.rows, parallel.spatial). matplotlib is refused too (the card's machine has none; the
harness's plot_results draws without it). A second test reads every
source file of unicorn_torch and finds no import statement of cv2, PIL,
matplotlib, JAX or the JAX package anywhere in it, inside functions too
(where an import happens only when called).
"""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "unicorn_tpu", "tools", "cv2",
           "PIL", "matplotlib")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import unicorn_torch
names = ["unicorn_torch"] + [
    m.name for m in pkgutil.walk_packages(unicorn_torch.__path__,
                                          "unicorn_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
for n in ("ops.deform_attn", "ops.correlation", "ops.correlation_kernel",
          "models.interaction", "drivers.sot", "losses.det", "losses.vos",
          "losses.uni", "losses.mask", "losses.boxinst", "core.schedule", "core.train_state",
          "core.train_step", "ops.convnext_block", "tracker.device_tracker",
          "drivers.stream", "drivers.inst", "drivers.vos",
          "tracker.qd_tracker", "tracker.legacy", "utils.boxes",
          "drivers.mot", "core.checkpoint", "core.trainer", "utils.logger",
          "utils.meters", "data", "data.preproc", "data.transforms",
          "data.loader", "data.datasets", "data.datasets.omni",
          "data.image_io", "data.datasets.coco", "data.datasets.sot",
          "data.datasets.mot", "data.datasets.vos", "data.datasets.bdd",
          "data.datasets.voc", "evaluators", "evaluators.rle",
          "data.mosaic", "tools", "tools.convert_datasets",
          "exp.unicorn_det_convnext_tiny_800x1280",
          "exp.unicorn_det_convnext_large_800x1280",
          "exp.unicorn_track_large", "models.resnet", "models.swin",
          "exp.base", "exp.unicorn_det_r50_800x1280",
          "exp.unicorn_track_r50", "exp.unicorn_track_r50_mask",
          "exp.unicorn_track_tiny_rt", "exp.unicorn_track_tiny_rt_mask",
          "exp.unicorn_track_tiny_sot_only",
          "exp.unicorn_track_tiny_mot_only",
          "exp.unicorn_track_tiny_vos_only",
          "exp.unicorn_track_tiny_mots_only",
          "exp.unicorn_track_large_mask",
          "exp.unicorn_track_large_mot_challenge",
          "exp.unicorn_track_large_mot_challenge_mask",
          "csrc.native", "evaluators.coco_map", "evaluators.coco_evaluator",
          "evaluators.coco_inst_evaluator", "evaluators.voc_eval",
          "evaluators.voc_evaluator", "evaluators.mot_metrics",
          "evaluators.mots_metrics", "evaluators.mot_evaluator",
          "evaluators.bdd_evaluator", "tools.eval", "harness",
          "harness.datasets", "harness.running", "harness.analysis",
          "harness.davis_metrics", "harness.submission", "tools.test",
          "tools.analysis_results", "utils.setup_env", "utils.label_ops",
          "utils.model_utils", "utils.profiling", "utils.visualize",
          "utils.debug_dump", "utils.demo_utils", "tools.common",
          "tools.interpolation", "tools.train", "tools.launch_uni",
          "tools.track", "tools.track_omni", "tools.demo",
          "tools.export_model", "parallel", "parallel.mesh",
          "parallel.multihost", "parallel.rows", "parallel.spatial",
          "drivers.seq_parallel", "harness._parallel_runners"):
    assert "unicorn_torch." + n in names, n
print(len(names))
"""


def test_port_imports_no_jax_nor_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # the package, its subpackages and the modules of slices 1 to 4
    assert int(proc.stdout.strip().splitlines()[-1]) >= 36


def test_port_sources_import_no_cv2_pil_nor_jax():
    blocked = {"cv2", "PIL", "jax", "jaxlib", "flax", "optax", "unicorn_tpu",
               "matplotlib"}
    found, n_files = [], 0
    for dirpath, _, files in os.walk(os.path.join(ROOT, "unicorn_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            n_files += 1
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    mods = [node.module or ""]
                else:
                    continue
                found += [(os.path.relpath(path, ROOT), node.lineno, m)
                          for m in mods if m.split(".")[0] in blocked]
    assert n_files > 100 and not found, found
