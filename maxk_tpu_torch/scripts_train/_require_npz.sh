#!/bin/bash
# Shared pre-flight for the real-dataset recipes: fail fast, with the
# exact bridge commands, when the preprocessed npz is absent or invalid.
# Usage: source maxk_tpu_torch/scripts_train/_require_npz.sh <dataset>
# (run from the repo root: it calls tools/verify_npz.py, which is
# engine-neutral, numpy only).
DS="$1"
DATA="${DATA_PATH:-./data}"
if [ ! -f "$DATA/$DS.npz" ]; then
  cat >&2 <<MSG
error: $DATA/$DS.npz not found.

This image has no egress and no dgl/ogb; preprocess on a machine that
has them, then copy the file here:

  python tools/convert_dgl_dataset.py --dataset $DS --out $DATA
  python tools/verify_npz.py $DATA/$DS.npz     # checks published stats
  bash $0 ...                                  # then re-run this recipe

MSG
  exit 2
fi
python tools/verify_npz.py "$DATA/$DS.npz" >/dev/null || {
  echo "error: $DATA/$DS.npz failed verification — re-run" \
       "tools/convert_dgl_dataset.py --dataset $DS --out $DATA" >&2
  exit 2
}
