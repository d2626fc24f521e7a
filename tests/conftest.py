def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (sm_90a) and nvcc; skips without")
