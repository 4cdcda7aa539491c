#!/bin/bash
# The archived full-size rcgan recipe (docs/runs/cifar_fullsize_rcgan_50k/command.txt)
# through the PyTorch port on one GPU, on its synthetic data, cut to NITERS
# iterations (default 5000: the evals land at 2499 and 4999). Prints the
# card and its power limit, the versions, the command's seconds and the end
# of the app's log; copies the log, log.pkl, metrics.jsonl and the sample
# grids to OUT (checkpoints stay in WORK: tens of MB each).
#
#   bash scripts/torch_cifar_recipe.sh [NITERS] [WORK] [OUT]
#
# Run from the repository's root (defaults: 5000 _smoke_archive/recipe
# chiprun_out/recipe). The data dir is WORK/data, which does not exist, so the
# app trains on the synthetic split whatever lies around the checkout.
niters=${1:-5000}
work=${2:-_smoke_archive/recipe}
out=${3:-chiprun_out/recipe}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
mkdir -p "$work" "$out"
t0=$(date +%s.%N)
RCGAN_SYNTH_CACHE=0 python3 -m rcgan_tpu_torch.apps.cifar_app --algorithm rcgan --alpha 0.6 \
  --run r5_rcgan --parent_dir "$work" --expt_dir r5_rcgan_5k --log_file "$work/rcgan.log" \
  --data_dir "$work/data" \
  --niters "$niters" --mesh_devices 1 --nomulti_gpu_multi_batch --compute_dtype bfloat16
rc=$?
t1=$(date +%s.%N)
echo "command seconds: $(python3 -c "print($t1 - $t0)") rc=$rc"
cp "$work/rcgan.log" "$out/"
d=$work/r5_rcgan_5k
cp "$d"/log.pkl "$d"/metrics.jsonl "$d"/command.txt "$d"/config.json "$d"/samples_*.png "$out/" 2>/dev/null
ls -la "$d" "$d/checkpoint"
grep -v "^$" "$work/rcgan.log" | tail -60
exit $rc
