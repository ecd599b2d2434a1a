#!/usr/bin/env bash
# CI-scale runs of the paper's experiment sections on the port (the JAX
# package's experiments/emnlp/run_all_ci.sh, through the port's drivers).
# Usage: bash llm_mixed_q_torch/experiments/emnlp/run_all_ci.sh [out_dir] [device]
# (device: cuda, the default, or cpu)
set -e
cd "$(dirname "$0")/../../.."
OUT="${1:-/tmp/emnlp_ci_torch}"
DEVICE="${2:-cuda}"
M=llm_mixed_q_torch.experiments.emnlp

run () {
  echo "=== $1 ==="
  shift
  "$@"
}

run "section 1 variance"      python -m $M.section_1_variance     --synthetic --device "$DEVICE" --save_dir "$OUT/sec1_variance"
run "section 4.2 perplexity"  python -m $M.section_4_2_perplexity --synthetic --device "$DEVICE" --save_dir "$OUT/sec42_ppl"
run "section 4.2 downstream"  python -m $M.section_4_2_downstream --synthetic --device "$DEVICE" --save_dir "$OUT/sec42_downstream"
run "section 4.3 QAT"         python -m $M.section_4_3_qat        --synthetic --device "$DEVICE" --save_dir "$OUT/sec43_qat"
run "section 4.4 search"      python -m $M.section_4_4_search     --synthetic --device "$DEVICE" --save_dir "$OUT/sec44_search"
echo "all sections OK -> $OUT"
