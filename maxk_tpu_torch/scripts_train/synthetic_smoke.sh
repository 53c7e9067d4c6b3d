#!/bin/bash
# CPU-runnable end-to-end smoke of the port's CLI: synthetic dataset, 30
# epochs (EPOCHS overrides), on DEVICE (default cuda; DEVICE=cpu here).
# The flags are scripts_train/synthetic_smoke.sh's.
K=${1:-16}; MODEL=${2:-sage}
python -m maxk_tpu_torch.train --dataset synthetic \
  --model $MODEL --hidden_layers 2 --hidden_dim 64 --nonlinear maxk \
  --maxk $K --dropout 0.2 --norm --w_lr 0.01 --epochs ${EPOCHS:-30} --timing \
  --device ${DEVICE:-cuda}
