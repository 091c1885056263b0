"""Host milliseconds a traced training step spends in the program's data
spans: the union of ``ucnerf.data.sample`` (pixels and rays on the host)
and ``ucnerf.data.to_device`` (the batch to the card), the program's own
counterpart of ``data_ms.train``."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "train", spans.DATA)
