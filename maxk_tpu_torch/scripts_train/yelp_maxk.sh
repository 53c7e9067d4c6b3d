#!/bin/bash
# The port's run of scripts_train/yelp_maxk.sh: the same flags to
# python -m maxk_tpu_torch.train, on DEVICE (default cuda).
# Yelp + MaxK recipe (reference scripts_train/yelp_maxk.sh:15-18:
# 4 layers, hidden 384, dropout 0.1, lr 0.001, 3000 epochs, norm; BCE loss).
K=${1:-32}; SEED=${2:-97}; MODEL=${3:-sage}
source "$(dirname "$0")/_require_npz.sh" yelp
python -m maxk_tpu_torch.train --dataset yelp --model $MODEL --hidden_layers 4 \
  --hidden_dim 384 --nonlinear maxk --maxk $K --seed $SEED \
  --dropout 0.1 --norm --w_lr 0.001 --epochs 3000 \
  --device ${DEVICE:-cuda}
