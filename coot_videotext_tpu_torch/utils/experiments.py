"""
Experiment file organization: path scheme, checkpoint enumeration, best/last
epoch discovery.

Port of coot_videotext_tpu/utils/experiments.py (parity with reference
nntrainer/experiment_organization.py:21-232). The weights are the
reference's `.pth` files: `models/model_<ep>.pth` ({net_name: state_dict},
the layout RetrievalModelManager.load_file reads) and
`models/optimizer_<ep>.pth`; the scheduler state is the JAX trainer's
`models/scheduler_<ep>.json` sidecar, and the trainerstate and metrics json
keep the reference's names and schema.
"""

from __future__ import annotations

import glob
import shutil
from pathlib import Path
from typing import List, Union

from coot_videotext_tpu_torch.config.base import BaseTrainerState
from coot_videotext_tpu_torch.utils.general import TrainerPathConst


class ExperimentFilesHandler:
    """File locations of one experiment run
    (experiments/<type>/<group>/<name>_<run>/...)."""

    def __init__(self, model_type: str, exp_group: str, exp_name: str,
                 run_name: str, *,
                 log_dir: str = TrainerPathConst.DIR_EXPERIMENTS) -> None:
        self.exp_group = exp_group
        self.exp_name = exp_name
        self.run_name = run_name
        self.model_type = model_type
        self.path_base: Path = (Path(log_dir) / self.model_type /
                                self.exp_group /
                                f"{self.exp_name}_{self.run_name}")
        self.path_logs = self.path_base / TrainerPathConst.DIR_LOGS
        self.path_models = self.path_base / TrainerPathConst.DIR_MODELS
        self.path_metrics = self.path_base / TrainerPathConst.DIR_METRICS
        self.path_embeddings = (self.path_base /
                                TrainerPathConst.DIR_EMBEDDINGS)

    def setup_dirs(self, *, reset: bool = False) -> None:
        if reset:
            shutil.rmtree(self.path_base, ignore_errors=True)
        for path in (self.path_logs, self.path_models, self.path_metrics):
            path.mkdir(parents=True, exist_ok=True)

    def get_existing_checkpoints(self) -> List[int]:
        """Epoch numbers with a saved trainerstate (reference :64)."""
        files = glob.glob(str(self.get_trainerstate_file("*")))
        prefix = TrainerPathConst.FILE_PREFIX_TRAINERSTATE
        return sorted(int(f.split(f"{prefix}_")[-1].split(".json")[0])
                      for f in files)

    def find_best_epoch(self) -> int:
        """Best epoch from the last trainerstate's infos_val_is_good flags
        (reference :79-102); -1 if there is no checkpoint."""
        ep_nums = self.get_existing_checkpoints()
        if not ep_nums:
            return -1
        state = BaseTrainerState.create_from_file(
            self.get_trainerstate_file(ep_nums[-1]))
        good = [e for e, g in zip(state.infos_val_epochs,
                                  state.infos_val_is_good) if g]
        if not state.infos_val_epochs or not good:
            return ep_nums[-1]
        return good[-1]

    # ---------- File definitions ----------

    def get_models_file(self, epoch: Union[int, str]) -> Path:
        return self.path_models / \
            f"{TrainerPathConst.FILE_PREFIX_MODEL}_{epoch}.pth"

    def get_models_file_ema(self, epoch: Union[int, str]) -> Path:
        """The caption trainer's EMA shadow, `{"model": state_dict}`."""
        return self.path_models / \
            f"{TrainerPathConst.FILE_PREFIX_MODELEMA}_{epoch}.pth"

    def get_optimizer_file(self, epoch: Union[int, str]) -> Path:
        return self.path_models / \
            f"{TrainerPathConst.FILE_PREFIX_OPTIMIZER}_{epoch}.pth"

    def get_scheduler_file(self, epoch: Union[int, str]) -> Path:
        return self.path_models / f"scheduler_{epoch}.json"

    def get_trainerstate_file(self, epoch: Union[int, str]) -> Path:
        return self.path_models / \
            f"{TrainerPathConst.FILE_PREFIX_TRAINERSTATE}_{epoch}.json"

    def get_metrics_step_file(self, epoch: Union[int, str]) -> Path:
        return self.path_metrics / \
            f"{TrainerPathConst.FILE_PREFIX_METRICS_STEP}_{epoch}.json"

    def get_metrics_epoch_file(self, epoch: Union[int, str]) -> Path:
        return self.path_metrics / \
            f"{TrainerPathConst.FILE_PREFIX_METRICS_EPOCH}_{epoch}.json"
