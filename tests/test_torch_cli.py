"""The port's CLI (python -m zerog_tpu_torch.cli) against zerog_tpu.cli on
the CPU: the same subcommands, and for predict, compute-accuracy, mock-proof
and generate-srs the same standard output on the same inputs (an HDF5 model
and PNG images that the test writes from seeds), with the seconds in
parentheses taken out. The port runs with ``--device cpu``.

The key, proof and EVM subcommands need a WNN keygen (k >= 12, minutes on
a CPU); chip_smoke.py's ``cli`` phase drives them on the card.
"""

import re

import numpy as np
import pytest
import torch

from zerog_tpu import cli as jcli
from zerog_tpu.curve import Srs as JSrs

from zerog_tpu_torch import cli
from zerog_tpu_torch.curve import Srs

from test_torch_io import _write_hdf5, _write_png
from test_torch_wnn import TOY, _fields, _toy_jax

torch.set_num_threads(1)

SUBCOMMANDS = ["predict", "compute-accuracy", "mock-proof", "generate-srs",
               "generate-keys", "dry-run-evm-verifier", "deploy-evm-verifier",
               "proof", "verify", "submit-proof"]


def _out(main, argv, capsys):
    main(argv)
    return re.sub(r" \([0-9.]+s\)", "", capsys.readouterr().out)


def _both(argv, capsys):
    """Standard output of the port's CLI (on the CPU) and of zerog_tpu's."""
    return _out(cli.main, ["--device", "cpu"] + argv, capsys), _out(jcli.main, argv, capsys)


@pytest.fixture(scope="module")
def model_and_image(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    _write_hdf5(d / "model.hdf5", seed=21)
    image = np.random.default_rng(22).integers(0, 256, (28, 28)).astype(np.uint8)
    _write_png(d / "image.png", image)
    return d / "model.hdf5", d / "image.png"


def test_help_lists_the_same_subcommands(capsys):
    listed = []
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(["--help"])
        assert e.value.code == 0
        listed.append(re.search(r"\{([a-z,-]+)\}", capsys.readouterr().out).group(1))
    assert listed[0] == listed[1] == ",".join(SUBCOMMANDS)


def test_predict_stdout_equal(model_and_image, capsys):
    model, image = model_and_image
    out, jout = _both(["predict", str(model), str(image)], capsys)
    assert out == jout and out.startswith("Scores: [") and "Prediction: " in out


def test_compute_accuracy_half(model_and_image, tmp_path, capsys):
    """One image labelled with the model's prediction, one with another
    class: accuracy 0.5 in both packages, as tests/test_wnn_predict.py
    checks on the reference model."""
    from zerog_tpu_torch.models import load_grayscale_image, load_wnn

    model, image = model_and_image
    scores = load_wnn(model).predict(load_grayscale_image(image))
    label = int(np.argmax(scores))
    (tmp_path / f"0000_{label}.png").write_bytes(image.read_bytes())
    (tmp_path / f"0001_{(label + 1) % 10}.png").write_bytes(image.read_bytes())
    (tmp_path / "notes.txt").write_text("not an image")
    out, jout = _both(["compute-accuracy", str(model), str(tmp_path)], capsys)
    assert out == jout == "Accuracy: 1/2 = 0.5000\n"


def test_mock_proof_toy_k12(tmp_path, monkeypatch, capsys):
    """mock-proof on the toy worked example at k = 12, under a working
    directory of its own since it writes real_wnn_layout.png. The toy's
    4 x 3 image has no square HDF5 form (load_wnn reads square images), so
    the model loader of each package is pointed at the toy model."""
    import zerog_tpu.models as jmodels
    import zerog_tpu_torch.models as models
    from PIL import Image
    from zerog_tpu_torch import convert

    jw = _toy_jax()
    monkeypatch.setattr(jmodels, "load_wnn", lambda path: jw)
    monkeypatch.setattr(models, "load_wnn",
                        lambda path: convert.wnn_from_reference(*_fields(jw)))
    _write_png(tmp_path / "toy.png", TOY["image"])
    outs = []
    for main, sub in ((cli.main, "port"), (jcli.main, "jax")):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        argv = ["mock-proof", "toy.hdf5", str(tmp_path / "toy.png"), "-k", "12"]
        outs.append(_out(main, (["--device", "cpu"] if sub == "port" else []) + argv,
                         capsys))
    assert outs[0] == outs[1] == ("Prediction: [1, 2]\nVerifying constraints...\n"
                                  "Valid!\nLayout written to real_wnn_layout.png\n")
    pngs = [np.asarray(Image.open(tmp_path / sub / "real_wnn_layout.png"))
            for sub in ("port", "jax")]
    assert np.array_equal(pngs[0], pngs[1])


def test_generate_srs_small_k(tmp_path, monkeypatch, capsys):
    """generate-srs at k = 4: the same line, the same file bytes, and each
    package's Srs.read gives equal points from either file."""
    outs = []
    for main, sub in ((cli.main, "port"), (jcli.main, "jax")):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        argv = ["generate-srs", "-k", "4", "--srs-path", "srs4.bin"]
        outs.append(_out(main, (["--device", "cpu"] if sub == "port" else []) + argv,
                         capsys))
    assert outs[0] == outs[1] == "SRS (k=4) written to srs4.bin\n"
    files = [tmp_path / sub / "srs4.bin" for sub in ("port", "jax")]
    assert files[0].read_bytes() == files[1].read_bytes()
    for path in files:
        s, js = Srs.read(path, device="cpu"), JSrs.read(path)
        assert (s.k, s.g, s.g_lagrange, s.g2, s.s_g2) == (
            js.k, js.g, js.g_lagrange, js.g2, js.s_g2)
        assert s.device.type == "cpu"
