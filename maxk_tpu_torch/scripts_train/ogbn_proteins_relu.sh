#!/bin/bash
# The port's run of scripts_train/ogbn_proteins_relu.sh: the same flags to
# python -m maxk_tpu_torch.train, on DEVICE (default cuda).
# ogbn-proteins + ReLU baseline (reference
# scripts_train/ogbn_proteins_relu.sh: 3 layers, hidden 256, dropout 0.5,
# lr 0.01, 1000 epochs, norm; BCE loss + rocauc, 112 binary targets).
SEED=${1:-97}; MODEL=${2:-sage}
source "$(dirname "$0")/_require_npz.sh" ogbn-proteins
python -m maxk_tpu_torch.train --dataset ogbn-proteins --model $MODEL --hidden_layers 3 \
  --hidden_dim 256 --nonlinear relu --seed $SEED \
  --dropout 0.5 --norm --w_lr 0.01 --epochs 1000 \
  --device ${DEVICE:-cuda}
