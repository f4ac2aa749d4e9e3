"""Images stepped per second over the whole window: the steps' images over
the device time between the CUDA events before the first and after the last
timed step."""


def read(rec):
    train = rec.get("train")
    return train["images"] / (train["window_ms"] / 1e3) if train and train["steps"] else None
