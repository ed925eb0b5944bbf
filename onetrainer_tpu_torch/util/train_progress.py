"""Training progress counters (reference: modules/util/TrainProgress.py)."""


class TrainProgress:
    def __init__(self, epoch: int = 0, epoch_step: int = 0, epoch_sample: int = 0, global_step: int = 0):
        self.epoch = epoch
        self.epoch_step = epoch_step
        self.epoch_sample = epoch_sample
        self.global_step = global_step

    def next_step(self, batch_size: int):
        self.epoch_step += 1
        self.epoch_sample += batch_size
        self.global_step += 1

    def next_epoch(self):
        self.epoch += 1
        self.epoch_step = 0
        self.epoch_sample = 0

    def filename_string(self) -> str:
        return f"{self.global_step}-{self.epoch}-{self.epoch_step}"

    def to_dict(self) -> dict:
        return {
            'epoch': self.epoch,
            'epoch_step': self.epoch_step,
            'epoch_sample': self.epoch_sample,
            'global_step': self.global_step,
        }

    @staticmethod
    def from_dict(data: dict) -> "TrainProgress":
        return TrainProgress(
            epoch=data.get('epoch', 0),
            epoch_step=data.get('epoch_step', 0),
            epoch_sample=data.get('epoch_sample', 0),
            global_step=data.get('global_step', 0),
        )
