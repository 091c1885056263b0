"""Host milliseconds a training step spends making its ray batch: the
harness's clock around ``RayDataset.sample_batch`` and
``step.batch_to_device``, the mean over the untraced steps of the window."""


def read(run):
    if run.kind != "train" or not run.host.get("data_s"):
        return None
    data = run.host["data_s"]
    return 1e3 * sum(data) / len(data)
