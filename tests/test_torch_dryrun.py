"""The port's dry run (``repro_torch.launch.dryrun``): the cell records
the JAX package's dry run writes, counted from the port's placement and a
pass of the step on ``meta`` tensors -- the reference's launch tests
(``tests/test_launch.py``) on the port, the metered extrapolation held to
a direct count of the whole model, the memory held to the unsharded
totals, and the command line's record for llama3.2-1b ``train_4k`` on the
single-pod mesh."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro_torch.configs as C  # noqa: E402
from repro_torch.configs import get_config, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_production_mesh,
    make_test_mesh,
)
from repro_torch.launch.steps import (  # noqa: E402
    all_shardings,
    batch_specs,
    lm_loss,
)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.parallel import sharding as TSH  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_shapes(monkeypatch):
    """``tests/test_launch.py:52-76``'s cut: tiny train and decode
    cells."""
    monkeypatch.setitem(C.SHAPES, "train_4k",
                        dict(kind="train", seq=32, batch=8))
    monkeypatch.setitem(C.SHAPES, "decode_32k",
                        dict(kind="decode", seq=64, batch=8))


def _unsharded(tree) -> int:
    if dataclasses.is_dataclass(tree):
        return sum(_unsharded(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(_unsharded(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _direct_flops(cfg, shape_id) -> int:
    """FLOPs of the whole model's step counted here, without the dry
    run's code: the training loss and its gradients, or one decode step."""
    sh = C.SHAPES[shape_id]
    cfg = dataclasses.replace(cfg, kv_chunk=1 << 30, ssd_unroll=1 << 30)
    model = build_model(cfg, device="meta")
    specs = batch_specs(cfg, sh["kind"], sh["batch"], sh["seq"])
    with FlopCounterMode(display=False) as fc:
        if sh["kind"] == "train":
            loss, _ = lm_loss(model, cfg, specs)
            torch.autograd.grad(loss, list(model.parameters()))
        else:
            cache = model.abstract_cache(sh["batch"], sh["seq"])
            model.decode_step(cache, specs["tokens"], specs["pos"])
    return int(fc.get_total_flops())


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
def test_run_cell_smoke(small_shapes, tmp_path, arch, shape):
    mesh = make_test_mesh((2, 4))
    rec = dryrun.run_cell(arch, shape, "single", smoke=True, mesh=mesh,
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("trace")
    assert json.loads((tmp_path / f"{arch}__{shape}__single.json")
                      .read_text())["status"] == "ok"
    cfg = get_config(arch, smoke=True)
    flops = rec["cost_raw"]["flops"]
    assert flops > 0
    assert rec["metered"]["total"]["flops"] == flops
    assert flops == _direct_flops(cfg, shape)
    # every position holds as much; together at least the whole
    cells = all_shardings(arch, shape, mesh, smoke=True)
    whole = (_unsharded(cells["abstract_params"])
             + _unsharded(cells["input_specs"]))
    if shape == "train_4k":
        whole += _unsharded(cells["abstract_opt"])
        wire = rec["collectives_raw"]["wire_bytes"]
        assert wire > 0 and rec["metered"]["total"]["wire"] == wire
        assert rec["cost_raw"]["data_positions"] == 2
    else:
        whole += _unsharded(cells["abstract_cache"])
        assert rec["collectives_raw"] is None
        assert rec["null_reasons"]["collectives_raw"]
    assert rec["memory"]["argument_size_in_bytes"] * mesh.size >= whole
    assert rec["positions"] == 8


def test_apply_opts_knobs():
    """``tests/test_launch.py:32``: the knobs the port honours, and a
    refusal for those it cannot."""
    cfg = dryrun._apply_opts(get_config("glm4-9b"),
                             "headpad16,remat=full,micro=4,capacity=1.0,"
                             "rules.embed=data,kvchunk=2048,cachef8")
    assert cfg.pad_heads_to == 16 and cfg.hq_padded == 32
    assert cfg.remat == "full"
    assert cfg.n_micro == 4
    assert cfg.capacity_factor == 1.0
    assert cfg.rules["embed"] == "data"
    assert cfg.kv_chunk == 2048
    assert cfg.cache_dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError):
        dryrun._apply_opts(cfg, "bogus")
    with pytest.raises(NotImplementedError):
        dryrun._apply_opts(cfg, "remat=dots_no_batch")
    with pytest.raises(NotImplementedError):
        dryrun._apply_opts(cfg, "seqshard")


def test_run_cell_skips_inapplicable(tmp_path):
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", out_dir=str(tmp_path))
    assert rec["status"] == "skipped"
    assert rec["reason"] == shape_applicable("llama3.2-1b", "long_500k")[1]


def test_dryrun_cli_llama_train_4k_single(tmp_path, capsys):
    """The command line on the production single-pod mesh (16 x 16 of
    ``meta``): status ok, FLOPs, per-position memory, collective bytes by
    kind, the fallbacks with llama's 8 KV heads, the fields with no
    counterpart null with a reason."""
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                 "--mesh", "single", "--out", str(tmp_path)])
    assert '"status": "ok"' in capsys.readouterr().out
    rec = json.loads((tmp_path / "llama3.2-1b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["positions"] == 256
    assert rec["cost_raw"]["flops"] == rec["metered"]["total"]["flops"] > 0
    assert rec["cost_raw"]["data_positions"] == 16
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(
        rec["memory_by_part"].values())
    for key in ("generated_code_size_in_bytes", "temp_size_in_bytes"):
        assert mem[key] is None and rec["null_reasons"][key]
    assert rec["cost_raw"]["bytes accessed"] is None
    assert rec["null_reasons"]["bytes accessed"]
    kinds = rec["collectives_raw"]["payload_bytes"]
    assert kinds["all-gather"] > 0 and kinds["all-reduce"] > 0
    assert kinds["reduce-scatter"] == 0
    assert {(a, d) for _, a, d, _ in rec["fallbacks"]} == {("kv_heads", 8)}
    # memory is the placement's: f32 parameters and two moments split 16
    # ways where they divide, the rest whole at every position
    cells = all_shardings("llama3.2-1b", "train_4k",
                          make_production_mesh())
    assert rec["memory_by_part"]["params"] == dryrun.position_bytes(
        cells["abstract_params"], cells["param_sharding"])
    assert rec["memory_by_part"]["opt"] == 2 * rec["memory_by_part"][
        "params"] + 4


def test_position_bytes_counts_what_placement_holds():
    """The dry run's count equals the bytes placed tensors hold, at every
    position of a host mesh."""
    from repro_torch.parallel.placement import device_put

    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    cells = all_shardings("granite-moe-3b-a800m", "train_4k", mesh,
                          smoke=True)
    model = build_model(cfg, device="cpu")
    placed = {n: device_put(p, cells["param_sharding"][n])
              for n, p in model.named_parameters()}
    held = sum(p.nbytes_by_position() for p in placed.values())
    want = dryrun.position_bytes(cells["abstract_params"],
                                 cells["param_sharding"])
    assert (held == want).all()
    TSH.fallback_log.clear()
