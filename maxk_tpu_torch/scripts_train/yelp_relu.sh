#!/bin/bash
# The port's run of scripts_train/yelp_relu.sh: the same flags to
# python -m maxk_tpu_torch.train, on DEVICE (default cuda).
# Yelp + ReLU baseline (reference scripts_train/yelp_relu.sh:16-19:
# 4 layers, hidden 384, dropout 0.1, lr 0.001, 3000 epochs, norm; BCE loss).
SEED=${1:-97}; MODEL=${2:-sage}
source "$(dirname "$0")/_require_npz.sh" yelp
python -m maxk_tpu_torch.train --dataset yelp --model $MODEL --hidden_layers 4 \
  --hidden_dim 384 --nonlinear relu --seed $SEED \
  --dropout 0.1 --norm --w_lr 0.001 --epochs 3000 \
  --device ${DEVICE:-cuda}
