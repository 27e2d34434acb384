"""Pytest settings of the port's tests: the ``gpu`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (PyTorch port kernels); skips "
        "without one.  On the card: python -m pytest "
        "tests/port/test_torch_gpu.py --noconftest")
