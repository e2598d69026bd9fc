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


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny"])
def test_run_cell_remat_opt_meters_the_policy(small_shapes, tmp_path, arch):
    """``opt="remat=..."``: the cell's FLOPs are the policy's (the
    products its backward recomputes), equal to a direct count and to the
    metered total, falling from ``full`` to ``dots_no_batch`` to
    ``dots``; the memory fields with no counterpart stay null, with their
    reason."""
    mesh = make_test_mesh((2, 4))
    got = {}
    for policy in ("full", "dots_no_batch", "dots"):
        rec = dryrun.run_cell(arch, "train_4k", "single", smoke=True,
                              mesh=mesh, out_dir=str(tmp_path),
                              opt=f"remat={policy}")
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["opt"] == f"remat={policy}"
        flops = rec["cost_raw"]["flops"]
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  remat=policy)
        assert flops == _direct_flops(cfg, "train_4k")
        assert rec["metered"]["total"]["flops"] == flops
        assert rec["memory"]["temp_size_in_bytes"] is None
        assert rec["null_reasons"]["temp_size_in_bytes"]
        got[policy] = flops
    assert got["full"] > got["dots_no_batch"] > got["dots"]


def test_apply_opts_knobs():
    """``tests/test_launch.py:32``: the JAX test's knobs, the port's other
    knobs, and ``seqshard``, which maps ``seq_res`` to ``"model"`` in the
    cell's rules and leaves the process-global ``RULES`` untouched (the
    JAX package writes ``RULES``)."""
    cfg = dryrun._apply_opts(get_config("glm4-9b"),
                             "headpad16,remat=dots_no_batch,micro=4,"
                             "capacity=1.0,rules.embed=data")
    assert cfg.pad_heads_to == 16 and cfg.hq_padded == 32
    assert cfg.remat == "dots_no_batch"
    assert cfg.n_micro == 4
    assert cfg.rules["embed"] == "data"
    with pytest.raises(ValueError):
        dryrun._apply_opts(cfg, "bogus")
    cfg = dryrun._apply_opts(cfg, "remat=dots,kvchunk=2048,cachef8")
    assert cfg.remat == "dots"
    assert cfg.capacity_factor == 1.0
    assert cfg.kv_chunk == 2048
    assert cfg.cache_dtype == torch.float8_e4m3fn
    assert dryrun._apply_opts(cfg, "remat=full").remat == "full"
    before = dict(TSH.RULES)
    seq = dryrun._apply_opts(cfg, "seqshard")
    assert seq.rules["seq_res"] == "model"
    assert seq.rules["embed"] == "data"  # the cell's other rules kept
    assert "seq_res" not in (cfg.rules or {})
    assert TSH.RULES == before and TSH.RULES["seq_res"] is None


@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi-3-vision-4.2b"])
def test_run_cell_seqshard_moves_the_activations_wire(small_shapes,
                                                      tmp_path, arch):
    """A train cell under ``opt="seqshard"``: the same FLOPs and total
    wire bytes; the activations' all-reduce wire becomes reduce-scatter
    plus all-gather of equal wire bytes, the gradients' is unchanged."""
    mesh = make_test_mesh((2, 4))
    recs = {opt: dryrun.run_cell(arch, "train_4k", "single", smoke=True,
                                 mesh=mesh, out_dir=str(tmp_path), opt=opt)
            for opt in (None, "seqshard")}
    plain, seq = recs[None], recs["seqshard"]
    assert plain["status"] == seq["status"] == "ok", seq.get("trace")
    assert plain["layout"] == seq["layout"] == "tensor"
    assert "layout_reason" not in plain
    assert plain["cost_raw"]["flops"] == seq["cost_raw"]["flops"]
    a = plain["collectives_raw"]["by_part"]
    b = seq["collectives_raw"]["by_part"]
    assert set(a["activations"]) == {"all-reduce"}
    assert b["activations"]["reduce-scatter"] == \
        b["activations"]["all-gather"]
    assert (b["activations"]["reduce-scatter"]
            + b["activations"]["all-gather"]
            == a["activations"]["all-reduce"])
    assert a["gradients"] == b["gradients"]
    assert (plain["collectives_raw"]["wire_bytes"]
            == seq["collectives_raw"]["wire_bytes"])
    assert seq["metered"]["total"]["wire"] == \
        seq["collectives_raw"]["wire_bytes"]


def test_run_cell_without_a_layout_keeps_the_storage_schedule(
        small_shapes, tmp_path):
    """A family the tensor layout does not cover yet keeps the storage
    schedule in the dry run, and the record names the ROADMAP item that
    ports its layout."""
    rec = dryrun.run_cell("mamba2-780m", "train_4k", "single", smoke=True,
                          mesh=make_test_mesh((2, 4)), out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["layout"] == "storage"
    assert "ROADMAP.md item" in rec["layout_reason"]
    assert rec["collectives_raw"]["payload_bytes"]["all-gather"] > 0


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
    # the train cell runs the tensor layout under the ambient mesh: the
    # activations' and the gradients' all-reduces, no parameter gathered
    assert rec["layout"] == "tensor"
    kinds = rec["collectives_raw"]["payload_bytes"]
    assert kinds["all-reduce"] > 0
    assert kinds["all-gather"] == kinds["reduce-scatter"] == 0
    assert kinds["collective-permute"] == 0
    parts = rec["collectives_raw"]["by_part"]
    assert set(parts) == {"activations", "gradients", "loss", "metrics"}
    assert {(a, d) for _, a, d, _ in rec["fallbacks"]} == {("kv_heads", 8)}
    # the forward ran under the ambient mesh: the activations' KV heads
    # fall back as the parameters' do, logged under "act" as in JAX
    assert ["act", "kv_heads", 8, "model"] in rec["fallbacks"]
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
