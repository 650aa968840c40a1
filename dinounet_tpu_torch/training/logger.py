"""Per-epoch metric logger with an optional progress.png.

Counterpart of ``dinounet_tpu/training/logger.py`` (ref: dinounet/training/
logging/nnunet_logger.py:9-103): fixed-key per-epoch series (train and
validation losses, per-class pseudo-Dice, its EMA with beta 0.9, learning
rates, epoch timestamps), a checkpointable state, and a 3-panel
progress.png when matplotlib is installed (the plot is skipped without it).
"""

import os


class nnUNetLogger:
    def __init__(self):
        self.my_fantastic_logging = {
            "mean_fg_dice": [],
            "ema_fg_dice": [],
            "dice_per_class_or_region": [],
            "train_losses": [],
            "val_losses": [],
            "lrs": [],
            "epoch_start_timestamps": [],
            "epoch_end_timestamps": [],
        }

    def log(self, key, value, epoch: int):
        if key not in self.my_fantastic_logging:
            raise KeyError(f"unknown logging key {key}")
        series = self.my_fantastic_logging[key]
        if key == "mean_fg_dice":
            ema = self.my_fantastic_logging["ema_fg_dice"]
            self.log("ema_fg_dice", ema[epoch - 1] * 0.9 + 0.1 * value if ema else value,
                     epoch)
        if len(series) < epoch + 1:
            series.append(value)
        else:
            series[epoch] = value

    def plot_progress_png(self, output_folder: str):
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("agg")
        import matplotlib.pyplot as plt

        log = self.my_fantastic_logging
        epoch = min(len(log["train_losses"]), len(log["val_losses"])) - 1
        if epoch < 0:
            return
        xs = list(range(epoch + 1))
        fig, axes = plt.subplots(3, 1, figsize=(10, 12), sharex=True)

        ax = axes[0]
        ax.plot(xs, log["train_losses"][: epoch + 1], ls="-", label="loss_tr")
        ax.plot(xs, log["val_losses"][: epoch + 1], ls="-", label="loss_val")
        ax2 = ax.twinx()
        ax2.plot(xs, log["mean_fg_dice"][: epoch + 1], ls="dotted", label="pseudo dice")
        ax2.plot(xs, log["ema_fg_dice"][: epoch + 1], ls="-",
                 label="pseudo dice (mov. avg.)")
        ax.set_ylabel("loss")
        ax2.set_ylabel("pseudo dice")
        ax.legend(loc=(0, 1))
        ax2.legend(loc=(0.4, 1))

        ax = axes[1]
        times = [e - s for s, e in zip(log["epoch_start_timestamps"][: epoch + 1],
                                       log["epoch_end_timestamps"][: epoch + 1])]
        ax.plot(xs, times, ls="-", label="epoch duration")
        ax.set_ylabel("time [s]")
        ax.legend(loc=(0, 1))

        ax = axes[2]
        ax.plot(xs, log["lrs"][: epoch + 1], ls="-", label="learning rate")
        ax.set_xlabel("epoch")
        ax.set_ylabel("learning rate")
        ax.legend(loc=(0, 1))

        plt.tight_layout()
        fig.savefig(os.path.join(output_folder, "progress.png"))
        plt.close(fig)

    def get_checkpoint(self) -> dict:
        return self.my_fantastic_logging

    def load_checkpoint(self, checkpoint: dict):
        self.my_fantastic_logging = checkpoint
