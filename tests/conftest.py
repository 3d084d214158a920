

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess checks (~1 min each)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
