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
                   "repro_torch.kernels.stacked_sweep"):
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
    ("repro_torch.core.distributed", {"two_round_exchange", "warm_round1"}),
    ("repro_torch.stream.sharded", {"ShardedMutableP2HIndex", "HashRouter"}),
    ("repro_torch.stream.resharding", {"VersionedRouter", "MigrationJournal",
                                       "plan_split", "plan_merge"}),
    ("repro_torch.parallel.sharding", {"mesh_signature"}),
])
def test_sharded_modules_import_alone(module, names):
    """Each module of the sharded slice imports on its own, first in a
    fresh interpreter, with ``jax`` and ``repro`` unimportable."""
    out = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert names <= set(ast.literal_eval(out.stdout))
