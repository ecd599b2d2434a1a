"""Mixed-precision quantization search (counterpart of the JAX package's
``search/search.py``; reference search/search.py:27-592,
``SearchQuantisationForClassification``). Objectives a trial: accuracy
(GLUE), memory density (the cost model), fps and fps per LUT (the DSE
stub, inert), each alpha-scaled and maximized; the Pareto front and the
threshold filter pick the winner.

The trial loop keeps the float32 parameters resident on their device: a
trial parses its sampled config and builds a forward over it
(``make_forward(..., quantize_weights=True)``, the fake-quant forward); no
weight moves. The artifacts are the JAX package's, byte for byte:
``search_log.csv``, ``results.csv`` (written with the ``csv`` module as
pandas writes it: the same columns, each float by its ``repr``),
``study.pkl``, ``best_trials/trial_<n>.toml`` and
``best_quant_config.toml``.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path

from ..eval import eval_cls_glue, eval_dse_results
from ..models import (
    get_config_cls,
    get_model_profiler,
    get_quant_config_parser,
    get_quant_config_sampler,
)
from ..models.api import make_forward
from ..utils.toml_io import load_config, save_config
from ..utils.trial_extractor import trial_to_quant_config
from .engine import FrozenTrial, Study, create_study, get_sampler

logger = logging.getLogger(__name__)

METRIC_NAMES = ("accuracy", "memory_density", "fps", "fps_per_lut")


def write_results_csv(path, rows: list[dict]):
    """The rows as pandas' ``DataFrame(rows).to_csv(path, index=False)``
    writes them: a header of the first row's keys, one line a row, floats
    by ``repr``, ``\\n`` line ends."""
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(rows[0]))
        for row in rows:
            writer.writerow([repr(v) if isinstance(v, float) else v for v in row.values()])


class SearchBase:
    def __init__(
        self,
        model_arch: str,
        model_name: str,
        task: str,
        search_config: dict | str,
        save_dir: str,
        params: dict,
        model_config_kwargs: dict | None = None,
    ):
        self.model_arch = model_arch
        self.model_name = model_name
        self.task = task
        self.search_config = (
            search_config
            if isinstance(search_config, dict)
            else load_config(search_config)
        )
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.params = params  # resident fp32 pytree — loaded ONCE
        self.config_cls = get_config_cls(model_arch)
        self.model_config_kwargs = model_config_kwargs or {}
        self.q_config_parser = get_quant_config_parser(model_arch)
        self.q_config_sampler = get_quant_config_sampler(model_arch)
        self.q_bitwidth_profiler = get_model_profiler(model_arch)

        self._csv_path = self.save_dir / "search_log.csv"
        self._csv_file = open(self._csv_path, "a")

    def _csv_log(self, line: str):
        self._csv_file.write(line + "\n")
        self._csv_file.flush()

    def make_model_config(self, quant_config):
        return self.config_cls(quant_config=quant_config, **self.model_config_kwargs)

    def make_forward(self, model_config):
        return make_forward(
            self.model_arch, self.task, model_config, quantize_weights=True
        )


class SearchQuantisationForClassification(SearchBase):
    """GLUE-driven mixed-precision search (reference search.py:93-592)."""

    def __init__(
        self,
        model_arch: str,
        model_name: str,
        search_config,
        save_dir,
        params: dict,
        num_labels: int = 2,
        model_config_kwargs: dict | None = None,
    ):
        mck = dict(model_config_kwargs or {})
        mck.setdefault("num_labels", num_labels)
        super().__init__(
            model_arch, model_name, "cls", search_config, save_dir, params, mck
        )
        self._pre_search_check()

    def _pre_search_check(self):
        est = self.search_config["search_estimator"]
        strat = self.search_config["search_strategy"]
        if est["alpha_accuracy"] == 0:
            assert strat["accuracy_threshold"] == 0
        if est["alpha_memory_density"] == 0:
            assert strat["avg_bitwidth_threshold"] == 0

    def compute_software_metric(
        self, forward_fn, params, task, eval_dataloader, is_regression, num_samples
    ) -> dict:
        results = eval_cls_glue(
            forward_fn,
            params,
            task,
            eval_dataloader,
            is_regression=is_regression,
            num_samples=num_samples,
        )
        if "accuracy" in results:
            return {"accuracy": results["accuracy"]}
        raise NotImplementedError(f"task {task} not supported as search metric")

    def compute_hardware_metric(self, model_config, seq_len, compare_to=32) -> dict:
        profile = self.q_bitwidth_profiler(model_config, seq_len)
        mem_density = (
            compare_to * profile["num_params"] + compare_to * profile["num_acts"]
        ) / (profile["param_bits"] + profile["act_bits"])
        dse = eval_dse_results(model_config, is_mixed=True)
        return {
            "memory_density": float(mem_density),
            "fps": dse["best_fps"],
            "fps_per_lut": dse["best_fps"] / dse["resource"],
        }

    def _trial_config(self, sampled: dict, num_layers: int) -> dict:
        """A trial's sampled seed -> its complete quant config (the
        conditional search derives frac widths here)."""
        return self.q_config_parser(sampled, num_layers, strict=False)

    def run_study(self, software_metric, seq_len: int, callbacks=()) -> Study:
        """The trials of the search config's strategy, each scored by
        ``software_metric(forward_fn) -> {"accuracy": ...}`` and the cost
        model, logged to ``search_log.csv``; the study and its results
        saved (``save_study_and_results``)."""
        est = self.search_config["search_estimator"]
        strat = self.search_config["search_strategy"]
        seed = self.search_config["search_space"]["quant_config_seed"]
        extend_first = self.search_config["search_space"].get(
            "extend_quant_config_seed_first", False
        )

        def objective(trial):
            quant_config_seed = seed
            num_layers = self.make_model_config(None).num_hidden_layers
            if extend_first:
                quant_config_seed = self.q_config_parser(
                    quant_config_seed, num_layers, strict=False
                )
            sampled = self.q_config_sampler(trial, "root", quant_config_seed)
            model_config = self.make_model_config(self._trial_config(sampled, num_layers))
            forward_fn = self.make_forward(model_config)
            s_metric = software_metric(forward_fn)
            h_metric = self.compute_hardware_metric(
                model_config, seq_len, compare_to=est["compare_to"]
            )
            metrics = {**s_metric, **h_metric}
            scaled = [metrics[m] * est[f"alpha_{m}"] for m in METRIC_NAMES]
            if trial.number == 0:
                self._csv_log(
                    "trial_id,"
                    + ",".join(METRIC_NAMES)
                    + ","
                    + ",".join(f"scaled_{m}" for m in METRIC_NAMES)
                )
            self._csv_log(
                f"{trial.number},"
                + ",".join(str(metrics[m]) for m in METRIC_NAMES)
                + ","
                + ",".join(map(str, scaled))
            )
            return tuple(scaled)

        sampler = get_sampler(strat["sampler"], seed=strat.get("seed"))
        study = create_study(directions=["maximize"] * 4, sampler=sampler)
        study.optimize(
            objective,
            n_trials=strat["n_trials"],
            n_jobs=strat.get("n_jobs", 1),
            timeout=strat.get("timeout"),
            callbacks=callbacks,
        )
        self.save_study_and_results(study)
        return study

    def search(
        self,
        eval_dataloader_factory,
        task: str,
        is_regression: bool,
        seq_len: int,
        num_samples_per_trial: int,
    ) -> Study:
        est = self.search_config["search_estimator"]

        def logger_callback(study, frozen: FrozenTrial):
            acc, mem, fps, fpl = frozen.values
            ori_mem = mem / (est["alpha_memory_density"] + 1e-8)
            avg_bitwidth = est["compare_to"] / (ori_mem + 1e-12)
            logger.info(
                f"Trial {frozen.number}: scaled={tuple(round(v, 4) for v in frozen.values)}, "
                f"avg_bitwidth={avg_bitwidth:.1f}"
            )

        return self.run_study(
            lambda forward_fn: self.compute_software_metric(
                forward_fn,
                self.params,
                task,
                eval_dataloader_factory(),
                is_regression,
                num_samples_per_trial,
            ),
            seq_len,
            callbacks=[logger_callback],
        )

    # ------------------------------------------------------------- results

    def save_study_and_results(self, study: Study):
        study.save(self.save_dir / "study.pkl")
        best_dir = self.save_dir / "best_trials"
        best_dir.mkdir(exist_ok=True)
        rows = []
        est = self.search_config["search_estimator"]
        for t in study.best_trials:
            qc = trial_to_quant_config(t, best_dir / f"trial_{t.number}.toml")
            acc, mem, fps, fpl = t.values
            rows.append(
                {
                    "trial_number": t.number,
                    "accuracy": acc / (est["alpha_accuracy"] + 1e-8),
                    "memory_density": mem / (est["alpha_memory_density"] + 1e-8),
                    "fps": fps / (est["alpha_fps"] + 1e-8),
                    "fps_per_lut": fpl / (est["alpha_fps_per_lut"] + 1e-8),
                    "avg_bitwidth": est["compare_to"]
                    / (mem / (est["alpha_memory_density"] + 1e-8) + 1e-12),
                }
            )
        write_results_csv(self.save_dir / "results.csv", rows)
        try:
            from tabulate import tabulate

            logger.info("\n" + tabulate(rows, headers="keys", tablefmt="pretty"))
        except ImportError:
            pass
        return rows

    def evaluate_best_trials(
        self,
        study: Study,
        eval_dataloader_factory,
        task: str,
        is_regression: bool = False,
    ):
        """Threshold-filter Pareto trials, multi-key sort, full eval of the
        winner (reference search.py:512-592)."""
        strat = self.search_config["search_strategy"]
        est = self.search_config["search_estimator"]
        acc_threshold = strat["accuracy_threshold"]
        avg_bitwidth_threshold = strat["avg_bitwidth_threshold"]
        sort_by = strat.get("sort_by", ["accuracy", "avg_bitwidth"])

        candidates = []
        for t in study.best_trials:
            acc = t.values[0] / (est["alpha_accuracy"] + 1e-8)
            mem = t.values[1] / (est["alpha_memory_density"] + 1e-8)
            avg_bitwidth = est["compare_to"] / (mem + 1e-12)
            if acc >= acc_threshold and (
                avg_bitwidth_threshold == 0 or avg_bitwidth <= avg_bitwidth_threshold
            ):
                candidates.append((t, acc, avg_bitwidth))
        if not candidates:
            logger.warning("No trial passed the thresholds; using full Pareto front")
            candidates = [
                (
                    t,
                    t.values[0] / (est["alpha_accuracy"] + 1e-8),
                    est["compare_to"]
                    / (t.values[1] / (est["alpha_memory_density"] + 1e-8) + 1e-12),
                )
                for t in study.best_trials
            ]

        def sort_key(item):
            keys = []
            for k in sort_by:
                if k == "accuracy":
                    keys.append(-item[1])
                elif k == "avg_bitwidth":
                    keys.append(item[2])
            return tuple(keys)

        candidates.sort(key=sort_key)
        best_trial = candidates[0][0]
        # the config the trial ran (``_trial_config``): the conditional
        # search derives its frac widths here, where the JAX package parses
        # the sampled widths alone and raises KeyError (ROADMAP fault 16)
        num_layers = self.make_model_config(None).num_hidden_layers
        qc = self._trial_config(trial_to_quant_config(best_trial), num_layers)
        model_config = self.make_model_config(qc)
        forward_fn = self.make_forward(model_config)
        results = eval_cls_glue(
            forward_fn,
            self.params,
            task,
            eval_dataloader_factory(),
            is_regression=is_regression,
        )
        save_config(
            trial_to_quant_config(best_trial),
            self.save_dir / "best_quant_config.toml",
        )
        return {"best_trial_number": best_trial.number, **results}
