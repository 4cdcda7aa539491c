#!/bin/bash
# The archived MNIST rcgan recipe (docs/runs/mnist_rcgan_100ep/command.txt)
# through the PyTorch port on one GPU, on its synthetic digits, cut to EPOCHS
# epochs (default 10: gen-label-acc lands at epochs 4 and 9, then the label
# recovery at the reference's 1000 steps on 500 images). Prints the card and
# its power limit, the versions, the command's seconds, the app's host
# seconds by phase (iterations/s from its "train" entry) and the end of its
# log; copies the log, log.pkl, metrics.jsonl, recovery.txt and the PNGs to
# OUT (checkpoints stay in WORK).
#
#   bash scripts/torch_mnist_recipe.sh [EPOCHS] [WORK] [OUT]
#
# Run from the repository's root (defaults: 10 _smoke_archive/mnist_recipe
# chiprun_out/mnist_recipe). The data dir is WORK/data, which does not exist,
# so the app trains on the synthetic digits whatever lies around the checkout.
epochs=${1:-10}
work=${2:-_smoke_archive/mnist_recipe}
out=${3:-chiprun_out/mnist_recipe}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
rm -rf "$work"
mkdir -p "$work" "$out"
t0=$(date +%s.%N)
RCGAN_SYNTH_CACHE="$work/synth" python3 -c '
import json, sys
from rcgan_tpu_torch.apps import mnist_app
stats = {}
ts, rec = mnist_app.main(sys.argv[1:], stats=stats)
sec, n = stats["train"]
print("stats", json.dumps(stats))
print(f"iterations {n} in {sec:.3f} s of training blocks: {n / sec:.3f} iterations/s")
print("recovery accuracy", rec["accuracy"])
' --algorithm rcgan --alpha 0.3 --disc_type projection --noestimate_confuse \
  --noaux_classifier --noadd_noise --noconcat_y --spectral_norm --max_norm --train \
  --epoch "$epochs" --batch_size 100 --checkpoint_dir "$work/runs" --data_dir "$work/data" \
  --logs_dir "$work/logs" --compute_dtype bfloat16 2>&1 | tee "$work/mnist.log"
rc=${PIPESTATUS[0]}
t1=$(date +%s.%N)
echo "command seconds: $(python3 -c "print($t1 - $t0)") rc=$rc"
cp "$work/mnist.log" "$out/"
d=$(ls -d "$work"/runs/rcgan_0.3_projection_* | head -n 1)
cp "$d"/log.pkl "$d"/metrics.jsonl "$d"/command.txt "$d"/config.json "$d"/recovery.txt \
  "$d"/recover_wrong_images.png "$d"/samples/*.png "$out/" 2>/dev/null
ls -la "$d" "$d/ckpt"
grep -E "EPOCH=|recovery|iterations/s|Epoch: \[ ?[0-9]+\] \[   0" "$work/mnist.log" | tail -40
exit $rc
