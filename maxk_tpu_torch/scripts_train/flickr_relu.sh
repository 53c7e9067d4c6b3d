#!/bin/bash
# The port's run of scripts_train/flickr_relu.sh: the same flags to
# python -m maxk_tpu_torch.train, on DEVICE (default cuda).
K=${1:-32}; SEED=${2:-97}; MODEL=${3:-sage}
source "$(dirname "$0")/_require_npz.sh" flickr
python -m maxk_tpu_torch.train --dataset flickr --model $MODEL --hidden_layers 3 \
  --hidden_dim 256 --nonlinear relu --seed $SEED \
  --dropout 0.2 --norm --selfloop --w_lr 0.001 --epochs 400 \
  --device ${DEVICE:-cuda}
