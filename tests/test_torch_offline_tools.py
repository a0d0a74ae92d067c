"""The port's offline data and scoring tools against the JAX package's tools
on the same inputs, each run in this process through its ``main`` with
``sys.argv`` patched (the JAX tools parse ``sys.argv``; the port's take it
when given no list), in ``tmp_path``.

* ``make_dataset`` (two sentences a language: the sentence lists patched in
  both): the same annotation lines and equal wavs.
* ``preprocess`` (from a base config, and from the built-in config with an
  auxiliary corpus): byte-equal ``final_annotation_*.txt`` and configs
  equal as JSON.
* ``resample``, ``denoise --method spectral`` (within 1e-6), and
  ``rearrange_speaker`` on a tiny ``.pth`` (equal tensors and configs).
* ``eval_pair``: the same printed metrics.
* ``eval_set`` and ``eval_vc`` with ``--device cpu`` on a tiny random-init
  ``.pth``: they run, and their aggregate JSON is finite.  Without a card,
  every scoring tool's default device raises ``SystemExit``.
"""

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from personalized_text_to_speech_tpu_torch.config import (
    save_hparams,
    tiny_model_config,
)
from personalized_text_to_speech_tpu_torch.data.audio import save_wav
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.tools import (
    denoise,
    eval_pair,
    eval_set,
    eval_vc,
    make_dataset,
    preprocess,
    rearrange_speaker,
    resample,
)
from personalized_text_to_speech_tpu_torch.utils.torch_compat import (
    save_torch_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent
BASE_CONFIG = str(REPO / "configs" / "finetune_speaker.json")

torch.set_num_threads(2)


def jax_tool(name):
    """``tools/<name>.py`` of the JAX package, imported as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(main, argv, monkeypatch, capsys):
    """``main()`` with ``sys.argv`` patched → (its return value, stdout)."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    out = main()
    return out, capsys.readouterr().out


def read_wav(path):
    sr, data = wavfile.read(path)
    return sr, data


def assert_same_wavs(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names and names == sorted(os.listdir(dir_b))
    for name in names:
        (sr_a, a), (sr_b, b) = read_wav(dir_a / name), read_wav(dir_b / name)
        assert sr_a == sr_b and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_make_dataset_matches_jax(tmp_path, monkeypatch, capsys):
    jax_mod = jax_tool("make_dataset")
    assert make_dataset.EN_SENTENCES == jax_mod.EN_SENTENCES
    assert make_dataset.ZH_SENTENCES == jax_mod.ZH_SENTENCES
    assert make_dataset.JA_SENTENCES == jax_mod.JA_SENTENCES
    for mod in (jax_mod, make_dataset):
        monkeypatch.setattr(mod, "EN_SENTENCES", ["A cup of tea.", "Rome was not built in a day."])
        monkeypatch.setattr(mod, "ZH_SENTENCES", ["我喜欢喝热茶。", "他每天早上六点起床跑步。"])
        monkeypatch.setattr(mod, "JA_SENTENCES", ["きょうはいいてんきです。", "やまがみえます。"])
    annos = {}
    for side, main in (("jax", jax_mod.main), ("port", make_dataset.main)):
        anno = tmp_path / f"{side}_anno.txt"
        run(main, ["--out_dir", str(tmp_path / side), "--anno_out", str(anno),
                   "--speakers", "klatt_m,klatt_f", "--languages", "CJE",
                   "--seed", "3"], monkeypatch, capsys)
        annos[side] = anno.read_text(encoding="utf-8").replace(
            str(tmp_path / side), "<dir>")
    assert annos["port"] == annos["jax"]
    assert len(annos["port"].splitlines()) == 12
    for spk in ("klatt_m", "klatt_f"):
        assert_same_wavs(tmp_path / "jax" / spk, tmp_path / "port" / spk)


ANNOTATIONS = [
    "a/0.wav|alice|[EN]The early bird catches the worm.[EN]",
    "a/1.wav|bob|[ZH]我喜欢喝热茶，也喜欢吃点心。[ZH]",
    "a/2.wav|alice|[JA]このほんはとてもおもしろいです。[JA]",
    "a/3.wav|carol|[EN]Numbers like 42 are read out.[EN]",
    "a/4.wav|bob|[EN]" + "A sentence far too long to keep. " * 5 + "[EN]",
]
AUXILIARY = [
    "b/0.wav|dave|[ZH]今天天气很好。[ZH]",
    "b/1.wav|erin|[EN]Honesty is the best policy.[EN]",
    "b/2.wav|dave|[KO]안녕하세요.[KO]",
] * 3


@pytest.mark.parametrize("case", ["base_config", "builtin_auxiliary"])
def test_preprocess_matches_jax(case, tmp_path, monkeypatch, capsys):
    jax_mod = jax_tool("preprocess")
    out = {}
    for side, main in (("jax", jax_mod.main), ("port", preprocess.main)):
        work = tmp_path / side
        work.mkdir()
        (work / "short_character_anno.txt").write_text(
            "\n".join(ANNOTATIONS) + "\n", encoding="utf-8")
        argv = ["--out_config", "cfg.json"]
        if case == "base_config":
            argv += ["--base_config", BASE_CONFIG, "--languages", "CJE"]
        else:
            (work / "sampled_audio4ft.txt").write_text(
                "\n".join(AUXILIARY) + "\n", encoding="utf-8")
            argv += ["--base_config", str(work / "none.json"), "--languages",
                     "CJ", "--add_auxiliary_data", "1"]
        monkeypatch.chdir(work)
        run(main, argv, monkeypatch, capsys)
        cfg = json.loads((work / "cfg.json").read_text(encoding="utf-8"))
        # the filelists' absolute paths differ by the working directory only
        for k, name in (("training_files", "train"), ("validation_files", "val")):
            assert cfg["data"][k] == str(work / f"final_annotation_{name}.txt")
            cfg["data"][k] = os.path.basename(cfg["data"][k])
        out[side] = (cfg, (work / "final_annotation_train.txt").read_bytes(),
                     (work / "final_annotation_val.txt").read_bytes())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1] and out["port"][2] == out["jax"][2]
    train_lines = out["port"][1].decode("utf-8").splitlines()
    # the over-long line is dropped; with CJ only the ZH auxiliary lines stay
    assert len(train_lines) == (4 if case == "base_config" else 3 + 4)


def test_resample_matches_jax(tmp_path, monkeypatch, capsys):
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(1)
    for i, (sr, ch) in enumerate(((16000, 1), (44100, 2), (22050, 1))):
        n = int(sr * 0.3)
        data = (0.3 * rng.standard_normal((n, ch)) * 32767).astype(np.int16)
        wavfile.write(src / f"c{i}.wav", sr, data.squeeze())
    (src / "notes.txt").write_text("skip me")
    for side, main in (("jax", jax_tool("resample").main), ("port", resample.main)):
        run(main, ["--in_dir", str(src), "--out_dir", str(tmp_path / side),
                   "--sr", "22050"], monkeypatch, capsys)
    assert_same_wavs(tmp_path / "jax", tmp_path / "port")


def test_denoise_spectral_matches_jax(tmp_path, monkeypatch, capsys):
    jax_mod = jax_tool("denoise")
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(2)
    sr = 16000
    t = np.arange(int(sr * 0.7)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) * (t > 0.2)
           + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    save_wav(str(src / "noisy.wav"), wav, sr)
    np.testing.assert_allclose(denoise.spectral_gate(wav, sr),
                               jax_mod.spectral_gate(wav, sr), rtol=0, atol=1e-6)
    outs = {}
    for side, main in (("jax", jax_mod.main), ("port", denoise.main)):
        _, text = run(main, ["--in_dir", str(src), "--out_dir",
                             str(tmp_path / side), "--sr", "22050",
                             "--method", "spectral"], monkeypatch, capsys)
        assert "(spectral)" in text
        sr_out, pcm = read_wav(tmp_path / side / "noisy.wav")
        assert sr_out == 22050
        outs[side] = pcm.astype(np.float64) / 32768.0
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0, atol=1e-6)


def test_rearrange_speaker_matches_jax(tmp_path, monkeypatch, capsys):
    hps = tiny_model_config(n_speakers=5)
    hps["speakers"] = {"carol": 3, "alice": 0, "bob": 4}
    cfg = str(tmp_path / "cfg.json")
    save_hparams(hps, cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        state = SynthesizerTrn.from_hparams(hps).state_dict()
    model = str(tmp_path / "G.pth")
    save_torch_checkpoint(state, model, iteration=7, learning_rate=1e-4)
    outs = {}
    for side, main in (("jax", jax_tool("rearrange_speaker").main),
                       ("port", rearrange_speaker.main)):
        names = {k: str(tmp_path / f"{side}_{k}") for k in
                 ("G.pth", "cfg.json", "moegoe.json")}
        run(main, ["--model_dir", model, "--config_dir", cfg,
                   "--out_model", names["G.pth"], "--out_config", names["cfg.json"],
                   "--out_moegoe", names["moegoe.json"]], monkeypatch, capsys)
        outs[side] = (torch.load(names["G.pth"], map_location="cpu",
                                 weights_only=False),
                      *(json.loads(Path(names[k]).read_text(encoding="utf-8"))
                        for k in ("cfg.json", "moegoe.json")))
    (pt, pt_cfg, pt_moe), (jx, jx_cfg, jx_moe) = outs["port"], outs["jax"]
    assert pt_cfg == jx_cfg and pt_moe == jx_moe
    assert pt_cfg["speakers"] == {"alice": 0, "carol": 1, "bob": 2}
    assert {k: v for k, v in pt.items() if k != "model"} == \
        {k: v for k, v in jx.items() if k != "model"}
    assert set(pt["model"]) == set(jx["model"]) == set(state)
    for k, v in jx["model"].items():
        assert pt["model"][k].dtype == v.dtype and torch.equal(pt["model"][k], v), k
    np.testing.assert_array_equal(pt["model"]["emb_g.weight"].numpy(),
                                  state["emb_g.weight"][[0, 3, 4]].numpy())


def _pair_wavs(tmp_path, sr=22050):
    t = np.arange(int(sr * 0.6)) / sr
    ref = 0.4 * np.sin(2 * np.pi * (180 + 40 * t) * t)
    syn = 0.35 * np.sin(2 * np.pi * 200 * t) + 0.01 * np.cos(2 * np.pi * 900 * t)
    paths = str(tmp_path / "ref.wav"), str(tmp_path / "syn.wav")
    save_wav(paths[0], ref, sr)
    save_wav(paths[1], syn, sr)
    return paths


@pytest.mark.parametrize("no_dtw", [False, True], ids=["dtw", "no_dtw"])
def test_eval_pair_matches_jax(no_dtw, tmp_path, monkeypatch, capsys):
    ref, syn = _pair_wavs(tmp_path)
    argv = ["--ref_wav", ref, "--syn_wav", syn] + (["--no_dtw"] if no_dtw else [])
    _, want = run(jax_tool("eval_pair").main, argv, monkeypatch, capsys)
    got_metrics, got = run(eval_pair.main, argv + ["--device", "cpu"],
                           monkeypatch, capsys)
    assert got == want
    assert "=== Metrics ===" in got and len(got_metrics) == 8


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A tiny random-init ``.pth``, its config, and annotations of 8 kHz
    clips: three texts, each said by speakers 0 and 1."""
    tmp = tmp_path_factory.mktemp("tiny_ckpt")
    hps = tiny_model_config(n_speakers=4)
    cfg = str(tmp / "cfg.json")
    save_hparams(hps, cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        state = SynthesizerTrn.from_hparams(hps).state_dict()
    model = str(tmp / "G.pth")
    save_torch_checkpoint(state, model)
    sr = hps.data.sampling_rate
    rng = np.random.default_rng(4)
    lines = []
    for i, text in enumerate(("ab ko→ no↓.", "ʃi ka↑ ɹu no.", "da to mi sa.")):
        for sid, f0 in ((0, 120.0), (1, 210.0)):
            n = int(sr * rng.uniform(0.5, 0.7))
            t = np.arange(n) / sr
            wav = sum(a * np.sin(2 * np.pi * f0 * h * t)
                      for h, a in ((1, 0.3), (2, 0.1), (3, 0.05)))
            path = str(tmp / f"u{i}_{sid}.wav")
            save_wav(path, wav, sr)
            lines.append(f"{path}|{sid}|{text}")
    anno = str(tmp / "anno.txt")
    Path(anno).write_text("\n".join(lines) + "\n", encoding="utf-8")
    return model, cfg, anno


def _finite(tree):
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    return isinstance(tree, str) or math.isfinite(tree)


def test_eval_set_runs_on_the_cpu(tiny_checkpoint, tmp_path, monkeypatch, capsys):
    model, cfg, anno = tiny_checkpoint
    out_json = tmp_path / "agg.json"
    result, text = run(eval_set.main, [
        "--model", model, "--config", cfg, "--annotations", anno,
        "--batch", "4", "--limit", "5", "--device", "cpu",
        "--out_dir", str(tmp_path / "wavs"), "--out_json", str(out_json)],
        monkeypatch, capsys)
    assert result["n_utterances"] == 5 and result["device"] == "cpu"
    assert _finite(result), result
    assert json.loads(text.strip().splitlines()[-1]) == result
    saved = json.loads(out_json.read_text(encoding="utf-8"))
    assert saved["aggregate"] == result and len(saved["per_utterance"]) == 5
    assert len(os.listdir(tmp_path / "wavs")) == 5


def test_eval_vc_runs_on_the_cpu(tiny_checkpoint, tmp_path, monkeypatch, capsys):
    model, cfg, anno = tiny_checkpoint
    result, text = run(eval_vc.main, [
        "--model", model, "--config", cfg, "--annotations", anno,
        "--src", "0", "--tgt", "1", "--limit", "2", "--device", "cpu"],
        monkeypatch, capsys)
    assert result["n_pairs"] == 2 and (result["src"], result["tgt"]) == (0, 1)
    assert _finite(result), result
    assert json.loads(text.strip().splitlines()[-1]) == result


@pytest.mark.parametrize("tool", [eval_pair, eval_set, eval_vc],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_scoring_tools_default_to_the_card(tool, tiny_checkpoint, tmp_path,
                                           monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    model, cfg, anno = tiny_checkpoint
    ref, syn = _pair_wavs(tmp_path)
    argv = {
        "eval_pair": ["--ref_wav", ref, "--syn_wav", syn],
        "eval_set": ["--model", model, "--config", cfg, "--annotations", anno],
        "eval_vc": ["--model", model, "--config", cfg, "--annotations", anno,
                    "--src", "0", "--tgt", "1"],
    }[tool.__name__.rsplit(".", 1)[-1]]
    with pytest.raises(SystemExit, match="no CUDA device"):
        run(tool.main, argv, monkeypatch, capsys)
