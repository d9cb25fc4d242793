import pytest

from benchmark import roofline


def test_request_bytes_are_input_read_once_and_output_written_once():
    assert roofline.request_bytes("compress", 1000, 400) == 1400  # object read, stream written
    assert roofline.request_bytes("decompress", 400, 1000) == 1400  # stream read, object written
    with pytest.raises(ValueError):
        roofline.request_bytes("sort", 1, 1)


def test_least_seconds_at_the_h100s_peak():
    reqs = [(3_350_000_000, 0), (0, 3_350_000_000)]
    assert roofline.least_seconds("compress", reqs, "NVIDIA H100 80GB HBM3") == pytest.approx(2e-3)
    with pytest.raises(KeyError):
        roofline.peak_bytes_per_s("cpu")
