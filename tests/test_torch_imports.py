"""The port stands alone: every module under ``src/repro_torch/`` imports
with ``jax`` and the JAX package ``repro`` made unimportable, and neither
reaches ``sys.modules``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r'''
import importlib
import pkgutil
import sys


def blocked(name):
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Block())
import repro_torch

names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print("\n".join(names))
'''


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(out.stdout.split())
    for module in ("repro_torch.serve.engine", "repro_torch.serve.batcher",
                   "repro_torch.serve.dispatch",
                   "repro_torch.serve.lambda_cache",
                   "repro_torch.serve.resilience",
                   "repro_torch.runtime.fault_tolerance",
                   "repro_torch.stream.wal", "repro_torch.stream.mutable",
                   "repro_torch.core.api",
                   "repro_torch.core.transform", "repro_torch.core.nh",
                   "repro_torch.core.fh",
                   "repro_torch.kernels.stacked_sweep",
                   "repro_torch.launch.mesh",
                   "repro_torch.parallel.collectives",
                   "repro_torch.stream.meshcheck",
                   "repro_torch.models.layers",
                   "repro_torch.models.attention",
                   "repro_torch.models.transformer",
                   "repro_torch.models.registry",
                   "repro_torch.models.convert",
                   "repro_torch.models.moe", "repro_torch.models.ssm",
                   "repro_torch.models.rglru", "repro_torch.models.whisper",
                   "repro_torch.configs.llama3_2_1b",
                   "repro_torch.configs.granite_moe_3b_a800m",
                   "repro_torch.configs.llama4_scout_17b_a16e",
                   "repro_torch.configs.mamba2_780m",
                   "repro_torch.configs.recurrentgemma_9b",
                   "repro_torch.configs.whisper_tiny",
                   "repro_torch.configs.phi_3_vision_4_2b",
                   "repro_torch.optim.adamw", "repro_torch.optim.grad",
                   "repro_torch.optim.schedule",
                   "repro_torch.launch.steps", "repro_torch.launch.train",
                   "repro_torch.launch.serve",
                   "repro_torch.parallel.placement",
                   "repro_torch.parallel.sharding",
                   "repro_torch.runtime.elastic",
                   "repro_torch.launch.dryrun"):
        assert module in names, module


_ALONE = r'''
import importlib
import sys


def blocked(name):
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Block())
mod = importlib.import_module(sys.argv[1])
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print(sorted(getattr(mod, "__all__", ())))
'''


@pytest.mark.parametrize("module,names", [
    ("repro_torch.core.distributed", {"two_round_exchange", "warm_round1",
                                      "ShardedP2HIndex"}),
    ("repro_torch.stream.sharded", {"ShardedMutableP2HIndex", "HashRouter"}),
    ("repro_torch.stream.resharding", {"VersionedRouter", "MigrationJournal",
                                       "plan_split", "plan_merge"}),
    ("repro_torch.parallel.sharding", {"mesh_signature"}),
    ("repro_torch.launch.mesh", {"DeviceMesh", "make_mesh",
                                 "make_serving_mesh", "mesh_context"}),
    ("repro_torch.parallel.collectives", {"all_gather", "pmin", "psum",
                                          "per_position"}),
    ("repro_torch.stream.meshcheck", {"run_churn_parity"}),
])
def test_sharded_modules_import_alone(module, names):
    """Each module of the sharded slice imports on its own, first in a
    fresh interpreter, with ``jax`` and ``repro`` unimportable."""
    out = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert names <= set(ast.literal_eval(out.stdout))


@pytest.mark.parametrize("module,names", [
    ("repro_torch.core.transform", {"lift", "sample_pairs", "sampled_lift",
                                    "nh_data_transform",
                                    "nh_query_transform"}),
    ("repro_torch.core.nh", {"NHIndex"}),
    ("repro_torch.core.fh", {"FHIndex"}),
])
def test_baseline_modules_import_alone(module, names):
    """Each module of the baselines' slice imports on its own, first in a
    fresh interpreter, with ``jax`` and ``repro`` unimportable."""
    out = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert names <= set(ast.literal_eval(out.stdout))


@pytest.mark.parametrize("module,names", [
    ("repro_torch.models.layers", {"ParamInit", "rmsnorm", "rope",
                                   "apply_rope", "mlp_apply", "dense"}),
    ("repro_torch.models.attention", {"gqa_attention", "attn_apply",
                                      "attn_init", "local_attention",
                                      "decode_attention", "attn_decode",
                                      "init_kv_cache"}),
    ("repro_torch.models.moe", {"moe_init", "moe_apply", "moe_capacity"}),
    ("repro_torch.models.ssm", {"mamba2_init", "mamba2_apply",
                                "mamba2_decode", "mamba2_state",
                                "ssd_chunked"}),
    ("repro_torch.models.rglru", {"rglru_init", "rglru_apply",
                                  "rglru_decode", "rglru_state",
                                  "linear_scan"}),
    ("repro_torch.models.whisper", {"WhisperED"}),
    ("repro_torch.models.transformer", {"StackedLM", "ArchConfig",
                                        "LayerSpec"}),
    ("repro_torch.models.registry", {"get_model", "get_config", "ARCH_IDS",
                                     "MODEL_FAMILIES", "build_model"}),
    ("repro_torch.models.convert", {"from_reference_arrays",
                                    "to_reference_arrays",
                                    "cache_from_reference",
                                    "cache_to_reference"}),
    ("repro_torch.configs", {"get_config", "get_model"}),
    ("repro_torch.optim", {"adamw_init", "adamw_update", "cosine_schedule",
                           "clip_by_global_norm", "ef_compress_grads"}),
    ("repro_torch.data.pipeline", {"SyntheticLMDataset",
                                   "global_batch_for_step"}),
    ("repro_torch.launch.steps", {"make_train_step", "lm_loss",
                                  "model_extras", "make_prefill_step",
                                  "make_decode_step"}),
    ("repro_torch.launch.train", {"TrainConfig", "train", "main"}),
    ("repro_torch.launch.serve", {"ServeConfig", "serve_inputs", "serve_len",
                                  "decode_steps", "serve_batch", "main"}),
])
def test_lm_modules_import_alone(module, names):
    """Each module of the LM substrate imports on its own, first in a
    fresh interpreter, with ``jax`` and ``repro`` unimportable."""
    out = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert names <= set(ast.literal_eval(out.stdout))


_EXAMPLE = r'''
import runpy
import sys


def blocked(name):
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"the example imported {name}")
        return None


sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[2])
mod = runpy.run_path(sys.argv[1], run_name="example")
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
assert callable(mod["main"])
'''


@pytest.mark.parametrize("example", ["quickstart_torch",
                                     "active_learning_torch",
                                     "serve_batch_torch",
                                     "train_lm_torch"])
def test_port_examples_import_neither_jax_nor_repro(example):
    """The port's examples load (their module body, not ``main``) with
    ``jax`` and ``repro`` unimportable."""
    path = SRC.parent / "examples" / f"{example}.py"
    out = subprocess.run([sys.executable, "-c", _EXAMPLE, str(path),
                          str(SRC)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("module,names", [
    ("repro_torch.parallel.sharding", {"RULES", "PartitionSpec",
                                       "logical_to_spec", "shard",
                                       "resolve_param_specs", "pad_vocab",
                                       "fallback_log"}),
    ("repro_torch.parallel.placement", {"NamedSharding", "PlacedTensor",
                                        "device_put", "gather"}),
    ("repro_torch.runtime.elastic", {"specs_for_mesh", "elastic_remesh"}),
    ("repro_torch.launch.dryrun", {"run_cell", "main"}),
    ("repro_torch.launch.steps", {"input_specs", "batch_logical",
                                  "abstract_opt_state", "all_shardings",
                                  "make_placed_train_step"}),
])
def test_placement_modules_import_alone(module, names):
    """Each module of LM placement imports on its own, first in a fresh
    interpreter, with ``jax`` and ``repro`` unimportable."""
    out = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert names <= set(ast.literal_eval(out.stdout))
