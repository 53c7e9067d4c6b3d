#!/bin/bash
# The port's run of scripts_train/ogbn_proteins_maxk.sh: the same flags to
# python -m maxk_tpu_torch.train, on DEVICE (default cuda).
# ogbn-proteins + MaxK (reference scripts_train/ogbn_proteins_maxk.sh:14-18:
# 3 layers, hidden 256, dropout 0.5, lr 0.01, 1000 epochs, norm;
# BCE loss + rocauc, 112 targets).
K=${1:-32}; SEED=${2:-97}; MODEL=${3:-sage}
source "$(dirname "$0")/_require_npz.sh" ogbn-proteins
python -m maxk_tpu_torch.train --dataset ogbn-proteins --model $MODEL --hidden_layers 3 \
  --hidden_dim 256 --nonlinear maxk --maxk $K --seed $SEED \
  --dropout 0.5 --norm --w_lr 0.01 --epochs 1000 \
  --device ${DEVICE:-cuda}
