"""Mixed-precision search driven by zero-shot prompting accuracy
(counterpart of the JAX package's ``search/prompting.py``; reference
``SearchQuantisationForPromptingCLS``, search/search.py:595-1101, and
``SearchIntQuantisationForPromptingCLS``, search_conditional.py:684-): the
GLUE search's skeleton with the mean prompting ``acc`` over tasks as the
software metric (``eval/prompting.py``), the parameters resident and the
model re-configured a trial.
"""

from __future__ import annotations

import logging

from ..eval.prompting import eval_prompting_tasks, load_task_examples
from ..models import get_stat_config_formatter
from ..utils.trial_extractor import trial_to_quant_config
from ..utils.toml_io import save_config
from .conditional import SearchIntQuantisationForClassification
from .engine import FrozenTrial, Study
from .search import SearchQuantisationForClassification

logger = logging.getLogger(__name__)


class SearchQuantisationForPromptingCLS(SearchQuantisationForClassification):
    """Search with mean zero-shot prompting accuracy as the software metric."""

    def __init__(
        self,
        model_arch: str,
        model_name: str,
        search_config,
        save_dir,
        params: dict,
        tokenizer,
        model_config_kwargs: dict | None = None,
    ):
        super().__init__(
            model_arch,
            model_name,
            search_config,
            save_dir,
            params,
            num_labels=2,
            model_config_kwargs=model_config_kwargs,
        )
        self.tokenizer = tokenizer
        self.search_task = "lm"

    @property
    def task(self):
        return "lm"

    @task.setter
    def task(self, value):  # SearchBase.__init__ assigns "cls"; keep "lm"
        pass

    def _pre_search_check(self):
        pass  # prompting search has no GLUE threshold invariants

    def compute_software_metric_prompting(
        self, forward_fn, params, tasks, limit, examples_by_task
    ) -> dict:
        res = eval_prompting_tasks(
            forward_fn,
            params,
            self.tokenizer,
            tasks,
            limit=limit,
            examples_by_task=examples_by_task,
        )
        return {"accuracy": res["mean_acc"]}

    def search_prompting(
        self,
        tasks: list[str],
        seq_len: int,
        limit: int | None = None,
        examples_by_task: dict | None = None,
    ) -> Study:
        if examples_by_task is None:
            examples_by_task = {t: load_task_examples(t) for t in tasks}

        def logger_callback(study, frozen: FrozenTrial):
            logger.info(
                f"Prompting trial {frozen.number}: "
                f"scaled={tuple(round(v, 4) for v in frozen.values)}"
            )

        return self.run_study(
            lambda forward_fn: self.compute_software_metric_prompting(
                forward_fn, self.params, tasks, limit, examples_by_task
            ),
            seq_len,
            callbacks=[logger_callback],
        )

    def evaluate_best_trials_prompting(
        self,
        study: Study,
        tasks: list[str],
        limit: int | None = None,
        examples_by_task: dict | None = None,
    ):
        """Threshold-filter the Pareto front, full prompting eval of the
        winner (reference search.py:1000-1101)."""
        strat = self.search_config["search_strategy"]
        est = self.search_config["search_estimator"]
        acc_threshold = strat.get("accuracy_threshold", 0)
        avg_bitwidth_threshold = strat.get("avg_bitwidth_threshold", 0)
        if examples_by_task is None:
            examples_by_task = {t: load_task_examples(t) for t in tasks}

        candidates = []
        for t in study.best_trials:
            acc = t.values[0] / (est["alpha_accuracy"] + 1e-8)
            mem = t.values[1] / (est["alpha_memory_density"] + 1e-8)
            avg_bw = est["compare_to"] / (mem + 1e-12)
            if acc >= acc_threshold and (
                avg_bitwidth_threshold == 0 or avg_bw <= avg_bitwidth_threshold
            ):
                candidates.append((t, acc, avg_bw))
        if not candidates:
            candidates = [(t, 0, 0) for t in study.best_trials]
        candidates.sort(key=lambda c: (-c[1], c[2]))
        best_trial = candidates[0][0]
        num_layers = self.make_model_config(None).num_hidden_layers
        qc = self._trial_config(
            trial_to_quant_config(best_trial), num_layers
        )
        model_config = self.make_model_config(qc)
        forward_fn = self.make_forward(model_config)
        res = eval_prompting_tasks(
            forward_fn,
            self.params,
            self.tokenizer,
            tasks,
            limit=limit,
            examples_by_task=examples_by_task,
        )
        save_config(
            trial_to_quant_config(best_trial),
            self.save_dir / "best_quant_config.toml",
        )
        return {"best_trial_number": best_trial.number, **res}


class SearchIntQuantisationForPromptingCLS(SearchQuantisationForPromptingCLS):
    """Conditional integer search on prompting tasks: sample widths only,
    derive frac_widths from a stat profile (reference
    search_conditional.py:684-…)."""

    def __init__(
        self,
        model_arch: str,
        model_name: str,
        search_config,
        save_dir,
        params: dict,
        tokenizer,
        stat_profile: dict,
        range_entry: str = "range_min_max",
        model_config_kwargs: dict | None = None,
    ):
        super().__init__(
            model_arch,
            model_name,
            search_config,
            save_dir,
            params,
            tokenizer,
            model_config_kwargs,
        )
        self.stat_profile = stat_profile
        self.range_entry = range_entry
        self.q_config_formatter = get_stat_config_formatter(model_arch)

    # the conditional classification search's config of a trial: the
    # sampled widths, frac widths from the stat profile, the arch's formatter
    _sampled_to_config = SearchIntQuantisationForClassification._sampled_to_config
    _trial_config = SearchIntQuantisationForClassification._trial_config
