"""The port's data pipeline against the reference's, and its training
launcher end to end on the CPU: batches bitwise equal for the same
``(seed, step, shard)``, the prefetcher, a killed run resumed from its
checkpoint, and a loss that falls.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

from repro.data import pipeline as rpipe  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,step,shard,shards", [
    (0, 0, 0, 1), (0, 3, 1, 2), (7, 11, 3, 4), (123, 0, 2, 4)])
def test_packed_batches_equal_the_reference_bitwise(seed, step, shard,
                                                    shards):
    kw = dict(seed=seed, vocab_size=512, seq_len=96, global_batch=4,
              doc_len_mean=40)
    want = rpipe.PackedLMDataset(rpipe.DataConfig(**kw)).batch(step, shard,
                                                              shards)
    got = pipeline.PackedLMDataset(pipeline.DataConfig(**kw)).batch(
        step, shard, shards)
    assert sorted(got) == sorted(want) == ["targets", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["targets"] < 0).any()


def test_data_config_and_corpus_equal_the_reference():
    assert [f.name for f in dataclasses.fields(pipeline.DataConfig)] == \
        [f.name for f in dataclasses.fields(rpipe.DataConfig)]
    assert dataclasses.asdict(pipeline.DataConfig()) == \
        dataclasses.asdict(rpipe.DataConfig())
    cfg = dict(seed=3, vocab_size=1000)
    a = pipeline.SyntheticCorpus(pipeline.DataConfig(**cfg))
    b = rpipe.SyntheticCorpus(rpipe.DataConfig(**cfg))
    for doc in (0, 5, 99):
        np.testing.assert_array_equal(a.document(doc), b.document(doc))


def test_prefetcher_yields_the_stream_in_order_and_closes():
    ds = pipeline.PackedLMDataset(pipeline.DataConfig(
        vocab_size=256, seq_len=32, global_batch=2))
    it = pipeline.Prefetcher(ds.iterate(start_step=5), depth=2)
    for step in range(5, 9):
        got = next(it)
        np.testing.assert_array_equal(got["tokens"], ds.batch(step)["tokens"])
    it.close()
    finite = pipeline.Prefetcher(iter([{"a": 1}, {"a": 2}]), depth=1)
    assert [x["a"] for x in finite] == [1, 2]


def test_stub_embedding_families_are_not_ported():
    """The audio and vlm families' batches, once item 11, carry their stub
    embeddings as the reference's do (audio: ``embeds`` in place of
    ``tokens``; vlm: ``prefix_embeds`` beside them), with the same targets;
    a mesh still raises (item 9)."""
    kw = dict(seed=5, vocab_size=512, seq_len=48, global_batch=4,
              doc_len_mean=40)
    want = rpipe.PackedLMDataset(rpipe.DataConfig(**kw)).batch(2, 1, 2)
    for arch, stub in (("musicgen-large", "embeds"),
                       ("paligemma-3b", "prefix_embeds")):
        cfg = registry.smoke(registry.get_config(arch))
        got = pipeline.PackedLMDataset(pipeline.DataConfig(**kw),
                                       cfg).batch(2, 1, 2)
        keys = {"targets", stub} | ({"tokens"} if stub == "prefix_embeds"
                                    else set())
        assert set(got) == keys
        np.testing.assert_array_equal(got["targets"], want["targets"])
        rows = 48 if stub == "embeds" else cfg.num_prefix_tokens
        assert got[stub].shape == (2, rows, cfg.d_model)
        assert got[stub].dtype == np.float32
    with pytest.raises(NotImplementedError, match="item 9"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", "2x1"])


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        *args], env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=REPO)
    assert p.returncode == 0, (p.stdout[-1500:], p.stderr[-1500:])
    return p.stdout


def test_kill_resume_end_to_end(tmp_path):
    """The port's twin of ``tests/test_substrate.py``'s drill: a run of 12
    steps checkpoints at 5 and 10; a restart to 15 steps resumes from 10
    with the same data order."""
    args = ["--batch", "2", "--seq", "64", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5", "--log-every", "1"]
    _run(args + ["--steps", "12"])
    out = _run(args + ["--steps", "15"])
    assert "resumed from step 10" in out, out
    assert "[train] step    10 " in out and "[train] step     9 " not in out
    assert "[train] done: 5 steps" in out, out


def test_train_loss_decreases(tmp_path):
    """The port's twin of ``tests/test_system.py``'s check, on llama3-8b
    (the reference's runs granite-8b, the same dense block)."""
    out = _run(["--steps", "40", "--batch", "4", "--seq", "128", "--lr",
                "3e-3", "--ckpt-dir", str(tmp_path)])
    lines = [l for l in out.splitlines() if l.startswith("[train] done")]
    assert lines, out
    first, last = lines[0].split("loss ")[1].split(" -> ")
    assert float(last) < float(first) - 0.3, lines[0]
