#!/bin/bash
# Convert pretrained vgg16 weights into the shared .npz layout with the
# PyTorch/CUDA port's converter (counterpart of the reference's
# experiments/scripts/convert_vgg16.sh): tpudenoise_torch/cli/convert.py
# reads a tf-slim checkpoint with numpy alone, flips conv1 RGB->BGR and
# makes fc6/fc7 dense. It does no device work.
#
# Usage: ./tpudenoise_torch/experiments/scripts/convert_vgg16.sh SRC [OUT]
#   SRC: tf-slim vgg_16.ckpt prefix
#   OUT: output .npz (default data/imagenet_weights/vgg16.npz)

set -x
set -e
export PYTHONUNBUFFERED="True"

SRC=$1
OUT=${2:-data/imagenet_weights/vgg16.npz}

if [ -z "${SRC}" ]; then
  echo "usage: $0 SRC [OUT]"
  exit 1
fi

mkdir -p "$(dirname "${OUT}")"

LOG="experiments/logs/convert_vgg16.txt"
mkdir -p experiments/logs
exec &> >(tee -a "$LOG")
echo Logging output to "$LOG"

python -m tpudenoise_torch.cli.convert --src "${SRC}" --net vgg16 --out "${OUT}"
