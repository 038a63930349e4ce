"""Command-line interface of the PyTorch/CUDA port, mirroring the reference
CLI's subcommands (reference src/main.rs:22-169) with the names, arguments,
defaults and printed lines of ``zerog_tpu/cli.py``:

  predict, compute-accuracy, mock-proof, generate-srs, generate-keys, proof,
  verify, dry-run-evm-verifier, deploy-evm-verifier, submit-proof

Artifacts persist between steps exactly as in the reference: SRS -> keys +
circuit params -> proof + outputs, in the same file formats as the JAX
package's. Run it as ``python -m zerog_tpu_torch.cli``. The SRS, keygen,
proof and device inference run on the CUDA card unless ``--device cpu`` is
given before the subcommand; without a card and without that option every
subcommand raises.
"""

from __future__ import annotations

import argparse
import pathlib
import time

from .device import resolve_device


def _load_model_image(args, need_image=True):
    from .models import load_wnn, load_grayscale_image

    wnn = load_wnn(args.model_path)
    img = load_grayscale_image(args.img_path) if need_image else None
    return wnn, img


def cmd_predict(args):
    wnn, img = _load_model_image(args)
    scores = [int(v) for v in wnn.predict(img)]
    from .utils import argmax

    print(f"Scores: {scores}")
    print(f"Prediction: {argmax(scores)}")


def cmd_compute_accuracy(args):
    from .models import load_wnn, load_grayscale_image, parse_png_file
    from .utils import argmax

    wnn = load_wnn(args.model_path)
    fwd = None
    correct = total = 0
    t0 = time.time()
    for path in sorted(pathlib.Path(args.img_dir).iterdir()):
        label = parse_png_file(path)
        if label is None:
            continue
        img = load_grayscale_image(path)
        if fwd is None:
            fwd = wnn.predict_fn(args.device)
        scores = fwd(img).tolist()
        correct += int(argmax(scores) == label)
        total += 1
        if total % 500 == 0:
            print(f"{total} images, accuracy so far {correct/total:.4f}")
    print(f"Accuracy: {correct}/{total} = {correct/total if total else 0:.4f} "
          f"({time.time()-t0:.1f}s)")


def cmd_mock_proof(args):
    wnn, img = _load_model_image(args)
    print(f"Prediction: {[int(v) for v in wnn.predict(img)]}")
    print("Verifying constraints...")
    wnn.mock_proof(img, args.k)
    print("Valid!")
    # render the layout map like the reference (src/main.rs:228)
    wnn.plot_circuit("real_wnn_layout.png", args.k)
    print("Layout written to real_wnn_layout.png")


def cmd_generate_srs(args):
    from .curve import Srs

    srs = Srs.setup(args.k, device=args.device)
    srs.write(args.srs_path)
    print(f"SRS (k={args.k}) written to {args.srs_path}")


def cmd_generate_keys(args):
    from .curve import Srs
    from .models import load_wnn
    from .models.keys_io import write_keys
    from .models.io import write_circuit_params

    wnn = load_wnn(args.model_path)
    srs = Srs.read(args.srs_path, device=args.device)
    t0 = time.time()
    pk = wnn.generate_proving_key(srs)
    write_keys(pk, args.pk_path, args.vk_path)
    write_circuit_params(wnn.get_circuit_params(), args.circuit_params_path)
    print(f"Keys written ({time.time()-t0:.1f}s): {args.pk_path}, {args.vk_path}")


def cmd_proof(args):
    from .curve import Srs
    from .models import load_wnn, load_grayscale_image
    from .models.keys_io import read_pk
    from .models.io import read_circuit_params, write_proof_with_output

    wnn = load_wnn(args.model_path)
    img = load_grayscale_image(args.img_path)
    srs = Srs.read(args.srs_path, device=args.device)
    params = read_circuit_params(args.circuit_params_path)
    pk = read_pk(args.pk_path, params)
    t0 = time.time()
    proof, outputs = wnn.proof(pk, srs, img)
    write_proof_with_output(proof, outputs, args.proof_path)
    print(f"Proof ({len(proof)} bytes, {time.time()-t0:.1f}s) written to {args.proof_path}")


def cmd_verify(args):
    from .curve import Srs
    from .models.keys_io import read_vk
    from .models.io import read_circuit_params, read_proof_with_output
    from .plonk.verifier import verify_proof

    srs = Srs.read(args.srs_path, device=args.device)
    params = read_circuit_params(args.circuit_params_path)
    vk = read_vk(args.vk_path, params)
    proof, outputs = read_proof_with_output(args.proof_path)
    t0 = time.time()
    verify_proof(vk, srs, [outputs], proof)
    print(f"Proof verified ({time.time()-t0:.1f}s). Outputs: {outputs}")


def cmd_dry_run_evm_verifier(args):
    from .curve import Srs
    from .eth import gen_evm_verifier, dry_run_verifier
    from .models import load_wnn, load_grayscale_image
    from .models.keys_io import read_pk
    from .models.io import read_circuit_params

    wnn = load_wnn(args.model_path)
    img = load_grayscale_image(args.img_path)
    srs = Srs.read(args.srs_path, device=args.device)
    params = read_circuit_params(args.circuit_params_path)
    pk = read_pk(args.pk_path, params)
    print("Generating proof...")
    proof, outputs = wnn.proof(pk, srs, img)
    print("Generating EVM verifier...")
    code = gen_evm_verifier(pk.vk, srs, [len(outputs)])
    print(f"Byte code size: {len(code)}")
    print("Dry-running EVM verifier...")
    gas = dry_run_verifier(code, [outputs], proof)
    print(f"=> Gas used: {gas}")


def cmd_deploy_evm_verifier(args):
    from .curve import Srs
    from .eth import gen_evm_verifier
    from .eth.client import EthClient
    from .models.keys_io import read_vk
    from .models.io import read_circuit_params

    srs = Srs.read(args.srs_path, device=args.device)
    params = read_circuit_params(args.circuit_params_path)
    vk = read_vk(args.vk_path, params)
    print("Generating EVM verifier...")
    code = gen_evm_verifier(vk, srs, [params.n_classes])
    client = EthClient(args.endpoint)
    try:
        print(f"Address: 0x{client.address.hex()}")
        print("Deploying...")
        addr = client.deploy_contract(code)
        print(f"Contract address: {addr}")
    finally:
        client.close()


def cmd_submit_proof(args):
    from .eth.client import EthClient
    from .models.io import read_proof_with_output

    proof, outputs = read_proof_with_output(args.proof_path)
    client = EthClient(args.endpoint)
    try:
        client.submit_proof(args.contract_address, proof, [outputs])
    finally:
        client.close()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zerog-tpu-torch", description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device of the SRS, keygen, proof and device "
                         "inference (default: the CUDA card; 'cpu' to run "
                         "on the CPU)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, *specs, help=None):
        s = sub.add_parser(name, help=help, description=help)
        for spec in specs:
            s.add_argument(*spec[0], **spec[1])
        s.set_defaults(fn=fn)
        return s

    model = (["model_path"], {"help": "path to the model .hdf5"})
    image = (["img_path"], {"help": "path to the image .png"})
    kflag = (["-k"], {"type": int, "required": True,
                      "help": "log2 of the number of rows"})
    srs_p = (["--srs-path"], {"default": "srs.bin"})
    pk_p = (["--pk-path"], {"default": "pk.npz"})
    vk_p = (["--vk-path"], {"default": "vk.npz"})
    cp_p = (["--circuit-params-path"], {"default": "circuit_params.json"})
    pr_p = (["--proof-path"], {"default": "proof.json"})
    ep_p = (["--endpoint"], {"default": "local",
                             "help": "'local' for an in-process dev node, "
                                     "or an HTTP JSON-RPC url (needs "
                                     "ETH_PRIVATE_KEY)"})

    add("predict", cmd_predict, model, image,
        help="Predict the class of a particular image")
    add("compute-accuracy", cmd_compute_accuracy, model, (["img_dir"], {}),
        help="Compute the accuracy of the model on a directory of images")
    add("mock-proof", cmd_mock_proof, model, image, kflag,
        help="Step 0: Mock-prove inference of an image (also renders the "
             "circuit layout PNG)")
    add("generate-srs", cmd_generate_srs, kflag, srs_p,
        help="Step 1: Generate the SRS")
    add("generate-keys", cmd_generate_keys, model, srs_p, pk_p, vk_p, cp_p,
        help="Step 2: Generate the proving and verifying keys")
    add("dry-run-evm-verifier", cmd_dry_run_evm_verifier, model, image,
        srs_p, pk_p, cp_p,
        help="Step 2.1: Generate the EVM verifier and run a test proof")
    add("deploy-evm-verifier", cmd_deploy_evm_verifier, srs_p, vk_p, cp_p,
        ep_p,
        help="Step 2.2: Generate and deploy the EVM verifier")
    add("proof", cmd_proof, model, image, srs_p, pk_p, cp_p, pr_p,
        help="Step 3: Prove inference of a particular image")
    add("verify", cmd_verify, srs_p, vk_p, cp_p, pr_p,
        help="Step 4: Verify the proof")
    add("submit-proof", cmd_submit_proof, pr_p,
        (["contract_address"], {"help": "address of the deployed verifier"}),
        ep_p,
        help="Step 4.1: Submit the proof to the (deployed) EVM verifier")

    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
