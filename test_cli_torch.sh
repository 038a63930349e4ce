#!/bin/bash
# CLI end-to-end exercise of the PyTorch/CUDA port (zerog_tpu_torch): the
# flow of test_cli.sh (all 10 subcommands incl. the EVM path) through
# `python -m zerog_tpu_torch.cli`. Expects the reference's model and image
# (MODELS: the folder of model_28input_256entry_1hash_1bpi.hdf5; IMG: a
# 28 x 28 PNG), h5py and PIL to read them, and a CUDA card: the proving
# subcommands run on it.
set -e

ZERO_G="python -m zerog_tpu_torch.cli"
MODELS=${MODELS:-reference/models}
IMG=${IMG:-reference/benches/example_image_7.png}
MNIST_PNG=${MNIST_PNG:-data/MNIST/png}

if [ ! -f "$MODELS/model_28input_256entry_1hash_1bpi.hdf5" ]; then
    echo "reference model data not found at $MODELS — skipping CLI e2e"
    exit 0
fi

# Each CLI invocation spawns its own in-process dev node; a shared state file
# makes deploy-evm-verifier and submit-proof hit the SAME chain state (the
# reference's flow against a long-running Anvil, test_cli.sh:40-83).
export ZEROG_DEV_NODE_STATE=test_data_torch/devnode_state.json
rm -f "$ZEROG_DEV_NODE_STATE"

$ZERO_G --help

mkdir -p test_data_torch

echo ""
echo "==== Running predict"
$ZERO_G predict "$MODELS/model_28input_256entry_1hash_1bpi.hdf5" "$IMG"

if [ -d "$MNIST_PNG" ]; then
    echo ""
    echo "==== Running compute-accuracy"
    $ZERO_G compute-accuracy "$MODELS/model_28input_256entry_1hash_1bpi.hdf5" "$MNIST_PNG"
fi

echo ""
echo "==== Running mock-proof"
$ZERO_G mock-proof "$MODELS/model_28input_256entry_1hash_1bpi.hdf5" "$IMG" -k 14

echo ""
echo "==== Running generate-srs"
$ZERO_G generate-srs -k 14 --srs-path test_data_torch/srs_14

echo ""
echo "==== Running generate-keys"
$ZERO_G generate-keys "$MODELS/model_28input_256entry_1hash_1bpi.hdf5" \
    --srs-path test_data_torch/srs_14 \
    --vk-path test_data_torch/vk.npz \
    --pk-path test_data_torch/pk.npz \
    --circuit-params-path test_data_torch/circuit_params.json

echo ""
echo "==== Running dry-run-evm-verifier"
$ZERO_G dry-run-evm-verifier "$MODELS/model_28input_256entry_1hash_1bpi.hdf5" "$IMG" \
    --srs-path test_data_torch/srs_14 \
    --pk-path test_data_torch/pk.npz \
    --circuit-params-path test_data_torch/circuit_params.json

echo ""
echo "==== Running deploy-evm-verifier"
DEPLOY_OUT=$($ZERO_G deploy-evm-verifier \
    --srs-path test_data_torch/srs_14 \
    --vk-path test_data_torch/vk.npz \
    --circuit-params-path test_data_torch/circuit_params.json | tee /dev/stderr)
VERIFIER_ADDR=$(echo "$DEPLOY_OUT" | grep -oE '0x[0-9a-fA-F]{40}' | tail -1)
test -n "$VERIFIER_ADDR" || { echo "no deploy address captured"; exit 1; }

echo ""
echo "==== Running proof"
$ZERO_G proof "$MODELS/model_28input_256entry_1hash_1bpi.hdf5" "$IMG" \
    --srs-path test_data_torch/srs_14 \
    --pk-path test_data_torch/pk.npz \
    --circuit-params-path test_data_torch/circuit_params.json \
    --proof-path test_data_torch/proof.json

echo ""
echo "==== Running verify"
$ZERO_G verify \
    --srs-path test_data_torch/srs_14 \
    --vk-path test_data_torch/vk.npz \
    --circuit-params-path test_data_torch/circuit_params.json \
    --proof-path test_data_torch/proof.json

echo ""
echo "==== Running submit-proof"
# Submit against the address captured from deploy (lands at the Anvil
# account-0 first-deploy address, 0x5fbd...0aa3, same convention as the
# reference). The shared dev-node state file makes this a REAL on-chain
# verification: the node rejects calls to code-less accounts, and we assert
# the receipt burned verifier-scale gas, so a vacuous success is impossible.
SUBMIT_OUT=$($ZERO_G submit-proof \
    --proof-path test_data_torch/proof.json \
    "$VERIFIER_ADDR" | tee /dev/stderr)
GAS=$(echo "$SUBMIT_OUT" | grep -oE 'Gas used: [0-9]+' | grep -oE '[0-9]+')
test -n "$GAS" && test "$GAS" -gt 100000 || {
    echo "submit-proof gas '$GAS' is not verifier-scale (> 100000)"; exit 1; }
echo "submit-proof verified on-chain with gas $GAS"
