"""The EMNLP reproduction drivers on the port: ``python -m
llm_mixed_q_torch.experiments.emnlp.<section> --synthetic --save_dir <dir>``
(``run_all_ci.sh`` runs all five)."""
