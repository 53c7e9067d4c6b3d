#!/bin/bash
# The port's run of scripts_train/reddit_relu.sh: the same flags to
# python -m maxk_tpu_torch.train, on DEVICE (default cuda).
K=${1:-32}; SEED=${2:-97}; MODEL=${3:-sage}
source "$(dirname "$0")/_require_npz.sh" reddit
python -m maxk_tpu_torch.train --dataset reddit --model $MODEL --hidden_layers 4 \
  --hidden_dim 256 --nonlinear relu --seed $SEED \
  --dropout 0.5 --norm --w_lr 0.01 --epochs 3000 \
  --device ${DEVICE:-cuda}
