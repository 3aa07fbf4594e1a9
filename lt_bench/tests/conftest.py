"""Settings of the benchmark's own tests (``python -m pytest lt_bench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips where torch.cuda.is_available() is False "
        "— run on the card with `python -m pytest lt_bench/tests -m cuda`",
    )
