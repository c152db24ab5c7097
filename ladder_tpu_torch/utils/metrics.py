"""Metric buffers and the per-epoch {exp}-result.npz: the port's copy of
``ladder_tpu/utils/metrics.py``, with the same buffer names and the exact
npz key set, so analysis written for either package reads the other's
results. The recorders take host values (numpy or Python numbers): the
trainer drains the device's metrics once per epoch before recording.
"""

from __future__ import annotations

import os

import numpy as np

BUFFER_NAMES = [
    "train_loss", "train_loss_prior", "val_loss", "val_loss_prior",
    "train_loss_ave_epoch", "val_loss_ave_epoch",
    "elbo_train", "elbo_val",
    "recons_error_train", "recons_error_val",
    "entropy_z_train", "entropy_z_val",
    "crossEntropy_prior_train", "crossEntropy_prior_val",
    "vampPrior_crossEntropy_prior_val", "vampPrior_crossEntropy_prior_train",
    "sigma_reguarisor_train", "sigma_reguarisor_val",
    "code_elbo_train", "code_elbo_val",
    "entropy_t_train", "entropy_t_val",
    "crossEntropy_t_train", "crossEntropy_t_val",
    "code_recons_error_train", "code_recons_error_val",
    "code_recons_likelihood_train", "code_inner_sigma_train",
    "iter_epochs_list", "test_batch_code_mean", "test_batch_code_std_dev",
    "test_sigma", "sigma_train",
    # classifier_accuracy is declared by the reference (base.py:565) but
    # never written anywhere in it — kept for buffer-name parity only.
    "classifier_accuracy",
    # the reference declares gmm_* (base.py:568-570) and also never writes
    # them; we populate them once per GM fit (trainer.fit_GMM_VI) so the
    # prior's evolution is inspectable. They are not part of the
    # {exp}-result.npz key set (base.py:791-823) and stay out of save().
    "gmm_mean", "gmm_cov", "gmm_weight",
]


class MetricsRecorder:
    def __init__(self):
        for name in BUFFER_NAMES:
            setattr(self, name, [])

    def record_ae_step(self, m):
        """After the ae sub-step (base.py:587-599)."""
        self.recons_error_train.append(float(m["l1_reconstruction_error"]))
        self.entropy_z_train.append(float(m["entropy_z"]))
        self.crossEntropy_prior_train.append(float(m["crossEntropy_prior"]))
        self.sigma_reguarisor_train.append(float(m["sigma_regularisor"]))
        self.elbo_train.append(float(m["elbo"]))
        self.train_loss.append(float(m["loss_ae"]))

    def record_sigma_step(self, m):
        self.sigma_train.append(float(m["sigma"]))

    def record_prior_step(self, m, prior):
        """After the prior sub-step (base.py:614-634)."""
        if prior in ("ours", "hierarchical"):
            self.code_recons_error_train.append(
                float(m["code_l1_reconstruction_error"]))
            self.code_recons_likelihood_train.append(
                float(m["code_reconstruction_likelihood"]))
            self.entropy_t_train.append(float(m["entropy_t"]))
            self.crossEntropy_t_train.append(
                float(m["crossEntropy_representation"]))
            self.code_elbo_train.append(float(m["elbo_prior"]))
            self.code_inner_sigma_train.append(float(m["inner_sigma"]))
        else:
            self.train_loss_prior.append(float(m["loss_prior"]))
            self.vampPrior_crossEntropy_prior_train.append(
                float(m["crossEntropy_prior"]))

    def record_val_step(self, m, model_to_train, prior):
        """base.py:643-679."""
        if model_to_train == "VAE":
            self.val_loss.append(float(m["loss_ae"]))
            self.recons_error_val.append(float(m["l1_reconstruction_error"]))
            self.entropy_z_val.append(float(m["entropy_z"]))
            self.elbo_val.append(float(m["elbo"]))
            self.crossEntropy_prior_val.append(float(m["crossEntropy_prior"]))
            return float(m["loss_ae"])
        if prior in ("ours", "hierarchical"):
            self.val_loss_prior.append(float(m["loss_prior"]))
            self.code_recons_error_val.append(
                float(m["code_l1_reconstruction_error"]))
            self.entropy_t_val.append(float(m["entropy_t"]))
            self.code_elbo_val.append(float(m["elbo_prior"]))
            self.crossEntropy_t_val.append(
                float(m["crossEntropy_representation"]))
            return float(m["loss_prior"])
        self.val_loss_prior.append(float(m["loss_prior"]))
        self.vampPrior_crossEntropy_prior_val.append(
            float(m["crossEntropy_prior"]))
        return float(m["loss_prior"])

    def save(self, config, num_para_list, n_train_iter, n_val_iter):
        """{exp}-result.npz with the reference's exact keys (base.py:791-823)."""
        file_name = os.path.join(
            config["result_dir"],
            "{}-result.npz".format(config["exp_name"]))
        np.savez(
            file_name,
            iter_list_val=self.iter_epochs_list,
            n_train_iter=n_train_iter,
            n_val_iter=n_val_iter,
            train_loss=self.train_loss,
            elbo_train=self.elbo_train,
            val_loss=self.val_loss,
            elbo_val=self.elbo_val,
            train_loss_prior=self.train_loss_prior,
            val_loss_prior=self.val_loss_prior,
            code_elbo_train=self.code_elbo_train,
            code_elbo_val=self.code_elbo_val,
            recons_loss_train=self.recons_error_train,
            recons_loss_val=self.recons_error_val,
            recons_loss_prior_train=self.code_recons_error_train,
            recons_loss_prior_val=self.code_recons_error_val,
            entropy_z_train=self.entropy_z_train,
            entropy_z_val=self.entropy_z_val,
            entropy_t_train=self.entropy_t_train,
            entropy_t_val=self.entropy_t_val,
            crossentropy_z_train=self.crossEntropy_prior_train,
            crossentropy_z_val=self.crossEntropy_prior_val,
            crossentropy_t_train=self.crossEntropy_t_train,
            crossentropy_t_val=self.crossEntropy_t_val,
            vampPrior_crossEntropy_z_train_prior=self.vampPrior_crossEntropy_prior_train,
            vampPrior_crossEntropy_z_val_prior=self.vampPrior_crossEntropy_prior_val,
            sigma_regularisor_train=self.sigma_reguarisor_train,
            sigma_regularisor_val=self.sigma_reguarisor_val,
            num_para_VAE=num_para_list,
            sigma=self.test_sigma,
        )
        return file_name
