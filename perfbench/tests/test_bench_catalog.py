"""Every file a cell needs is found by its name; a new cell is new
files only; nothing run loads JAX or the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import bench
from tiny import BENCH, ROOT, tiny_root


def test_every_cell_finds_its_files_by_name():
    cat = bench.Catalog()
    for w in cat.spec["workloads"]:
        config = cat.config(w["config"])
        t = cat.traffic(w["traffic"])
        assert cat.limits(w["name"])["limits"]
        assert hasattr(cat.module("kinds", t["kind"]), "run")
        assert hasattr(cat.module("reference", config["family"]),
                       "logits_at")
        assert hasattr(cat.module("counts", config["family"]),
                       "prefill_flops")
        e2e = [m["name"] for m in cat.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = cat.per_layer(w["name"])
        assert layer
        for m in layer:
            assert hasattr(cat.module("metrics", m["name"]), "read")
            assert m["moves"] in e2e


def test_config_files_state_source_sizes_and_departures():
    cat = bench.Catalog()
    for c in cat.spec["configs"]:
        f = cat.config(c["name"])
        assert f["source"] == c["source"]
        assert f["reduced"] == c["reduced"] == []
        assert f["published"] and f["departures"] and f["deployment"]
        pub, m = f["published"], f["model"]
        assert m["d_model"] == pub["hidden_size"]
        assert m["layers"] == pub["num_hidden_layers"]
        assert m["n_heads"] == pub["num_attention_heads"]
        assert m["kv_heads"] == pub["num_key_value_heads"]
        assert m["vocab"] == pub["vocab_size"]
        assert m.get("expert_d_ff", m["d_ff"]) == pub["intermediate_size"]
        assert m.get("n_experts", 0) == pub.get("num_experts", 0)
        assert m.get("experts_topk", 0) == pub.get("num_experts_per_tok", 0)
        assert f["init_std"] == pub["initializer_range"]


def test_the_harness_names_no_cell():
    for path in list((BENCH / "harness").glob("*.py")) + [BENCH / "run.py"]:
        text = path.read_text()
        for word in ("stablelm", "olmoe", "docqa", "train_4k"):
            assert word not in text, (path, word)


def test_a_new_cell_is_new_files_only(tmp_path):
    from perfbench import run

    root = tiny_root(tmp_path)
    bench_dir = root / "perfbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*")
              if p.is_file()}
    cfg = json.loads((bench_dir / "configs" / "tiny_dense.json").read_text())
    cfg["model"] = dict(cfg["model"], d_ff=80, layers=1)
    (bench_dir / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "tiny_serve.json").read_text())
    mix.update(prompt_tokens=[20, 30], answer_tokens=[3, 4])
    (bench_dir / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "throwaway.throwaway_mix.json").write_text(
        json.dumps({"limits": {"widest_gap": 0.1, "wrong_lengths": 0}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway", "source": "tiny",
                            "file": "perfbench/configs/throwaway.json",
                            "reduced": [], "why": "CPU test"})
    spec["workloads"].append({"name": "throwaway.throwaway_mix",
                              "config": "throwaway",
                              "traffic": "throwaway_mix", "chips": 1,
                              "why": "CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    rc = run.main(["--workload", "throwaway.throwaway_mix", "--seed", "7",
                   "--seconds", "0.5", "--trace", "0"], device="cpu",
                  root=root)
    assert rc == 0


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_fake.x", object())
    monkeypatch.setitem(sys.modules, "jaxy", object())
    assert bench.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert {"jaxlib", "repro"} <= set(bench.forbidden_modules())


@pytest.mark.parametrize("cell", ["tiny_dense.tiny_train",
                                  "tiny_moe.tiny_serve"])
def test_a_run_loads_neither_jax_nor_the_jax_package(cell, tmp_path):
    root = tiny_root(tmp_path)
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import run\n"
        "rc = run.main(['--workload', %r, '--seed', '11', '--seconds',"
        " '0.3', '--trace', '1'], device='cpu', root=__import__('pathlib')"
        ".Path(%r))\n"
        "from perfbench.harness.bench import forbidden_modules\n"
        "print('LOADED', forbidden_modules(), rc)\n"
    ) % (str(ROOT / "src"), str(ROOT), cell, str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert "LOADED [] 0" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]
    line = json.loads([l for l in out.stdout.splitlines()
                       if l.startswith("{")][-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
