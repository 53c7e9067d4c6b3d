#!/bin/bash
# The port's run of scripts_train/ogbn_products_maxk.sh: the same flags to
# python -m maxk_tpu_torch.train, on DEVICE (default cuda).
# ogbn-products + MaxK (reference scripts_train/ogbn_products_maxk.sh:14-24:
# 3 layers, hidden 256, dropout 0.5, lr 0.003, 500 epochs, norm;
# selfloop except for sage).
K=${1:-32}; SEED=${2:-97}; MODEL=${3:-sage}
source "$(dirname "$0")/_require_npz.sh" ogbn-products
EXTRA=""
if [ "$MODEL" != "sage" ]; then EXTRA="--selfloop"; fi
python -m maxk_tpu_torch.train --dataset ogbn-products --model $MODEL --hidden_layers 3 \
  --hidden_dim 256 --nonlinear maxk --maxk $K --seed $SEED \
  --dropout 0.5 --norm --w_lr 0.003 --epochs 500 $EXTRA \
  --device ${DEVICE:-cuda}
