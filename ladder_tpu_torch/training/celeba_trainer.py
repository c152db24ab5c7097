"""The CelebA joint trainer (the port of
``ladder_tpu/training/celeba_trainer.py``, the reference's
CelebATrainer_joint_training, its codes/trainers.py:130-248).

TFRecord batches (data/celeba.py: the train and validation batches copied
to the device in the prefetch thread), the fixed test batch from
celebA_test.tfrecords, the staircase lr (/1, /2, /5, /10 at epochs
25/50/75 with a restarted 0.99 decay), validation from
celebA_val.tfrecords, and every quirk of the reference that
``ladder_tpu`` keeps: the gates on TRAIN_VAE and TRAIN_prior, and the
validation average over n_val_iter whatever was recorded. Its mid-epoch
reconstruction snapshots at ``idx_check_point`` are plots; the port trains
with plots off (JointTrainer.mid_epoch_hook).
"""

from __future__ import annotations

import numpy as np

from ladder_tpu_torch.training import schedules
from ladder_tpu_torch.training.trainer import JointTrainer


class CelebATrainer(JointTrainer):
    def __init__(self, model, data, config, device="cuda"):
        super().__init__(model, data, config, device)
        self._test_batch = self.data.test.first_batch(config["batch_size"])
        n_iter = self.n_train_iter()
        step = max(n_iter // max(config["num_iter_to_plot"], 1), 1)
        self.idx_check_point = np.arange(0, n_iter - 1, step)

    def current_lr_ae(self):
        return schedules.lr_ae_celeba(self.config, self.cur_epoch)

    def train_batches(self):
        # the read and the host-to-device copy of batch k+1 overlap step k
        return self.data.train.epoch(self.config["batch_size"],
                                     seed=self.cur_epoch,
                                     to_device=self.device)

    def val_batches(self):
        return self.data.val.epoch(self.config["batch_size"],
                                   seed=self.cur_epoch,
                                   to_device=self.device)

    def sample_batches(self, n_samples):
        bs = self.config["batch_size"]
        n_batch = max(n_samples // bs, 1)
        # prefetch=False: this iterator is abandoned after n_batch batches
        # of a full epoch; a prefetch thread would read ahead for nothing
        gen = self.data.train.epoch(bs, seed=self.cur_epoch * 7919 + 1,
                                    prefetch=False)
        for i, b in enumerate(gen):
            if i >= n_batch:
                return
            yield b

    def test_batch(self):
        return self._test_batch

    def n_train_iter(self):
        return self.data.n_train // self.config["batch_size"]

    def n_val_iter(self):
        return max(self.data.n_val // self.config["batch_size"], 1)

    def val_vae_enabled(self):
        """CelebA gates VAE validation on TRAIN_VAE (trainers.py:180)."""
        return self.config["TRAIN_VAE"] == 1

    def val_prior_enabled(self):
        """CelebA also gates the prior val record on TRAIN_prior
        (trainers.py:183)."""
        return self.config["TRAIN_prior"] == 1

    def append_val_average(self, val_loss_sum, n_val):
        """CelebA divides by n_val_iter unconditionally (trainers.py:186):
        with TRAIN_VAE=0 the epoch average is recorded as 0.0, as the
        reference does."""
        self.metrics.val_loss_ave_epoch.append(
            val_loss_sum / self.n_val_iter())
