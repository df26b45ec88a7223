"""PyTorch port: the three examples (`examples/*_torch.py`) run through
their `main` on the CPU at their smallest sizes, checked on what they
print and return; the serving example's bytes against the JAX package's
bytes model."""
import importlib.util
import math
import pathlib

import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.roofline import analysis as jra

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_and_decodes(tmp_path, capsys):
    res = _load("quickstart_torch").main(
        ["--device", "cpu", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "logits: (2, 32, 512) finite: True" in out
    assert "'total': 787736" in out                  # 4L x d128, K=2
    assert res["logits_finite"] and len(res["losses"]) == 20
    assert all(math.isfinite(x) for x in res["losses"])
    assert f"final loss: {res['final_loss']}" in out
    assert len(res["generated"]) == 2 and len(res["generated"][0]) == 8
    assert f"generated: {res['generated'][0]}" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"step-{10:09d}", f"step-{20:09d}"]            # every 10 steps


def test_train_altup_lm_checkpoints_and_resumes(tmp_path, capsys):
    """--tiny: 4 steps with a checkpoint at 2 and 4, then a resume from
    step 4 to 6; the model card's count for the ~100M model."""
    mod = _load("train_altup_lm_torch")
    argv = ["--tiny", "--device", "cpu", "--ckpt", str(tmp_path),
            "--checkpoint-every", "2"]
    first = mod.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "done: step=4" in out and "resumed" not in out
    assert (tmp_path / f"step-{4:09d}").exists()
    second = mod.main(argv + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: step=6" in out
    assert second["resumed_from"] == 4 and len(second["losses"]) == 2
    assert all(math.isfinite(x) for x in first["losses"] + second["losses"])
    assert first["params"] == second["params"] == 787736
    big = mod.model_100m()
    assert (big.n_layers, big.d_model, big.n_heads, big.n_kv_heads,
            big.vocab_size, big.altup.K) == (12, 768, 12, 4, 32000, 2)


def test_serve_altup_adds_no_kv_bytes_and_paged_matches(capsys):
    res = _load("serve_altup_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert res["added_cache_bytes"] == 0
    assert "0 added KV-cache bytes (0 added bytes read a step)" in out
    # the bytes a step reads, as the reference's model counts them
    for K, got in res["kv_read_bytes"].items():
        cfg = jcfg.ModelConfig(name="serve", family="dense", n_layers=4,
                               d_model=128, n_heads=4, n_kv_heads=2,
                               d_ff=256, vocab_size=512,
                               altup=jcfg.AltUpConfig(K=K))
        assert got == jra.decode_kv_bytes(cfg, [64] * 4, T=64,
                                          kv_dtype="auto")
    assert res["paged_equals_contiguous"]
    assert "paged tokens == contiguous tokens: True" in out
    toks = res["tokens"]["contiguous"]
    assert sorted(len(t) for t in toks.values()) == [4, 6, 8, 10, 12, 14]
    assert len(res["stream"]) == 12 and "stream deltas" in out
