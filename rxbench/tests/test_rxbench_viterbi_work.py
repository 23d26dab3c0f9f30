"""The Viterbi work count of ``viterbi_roofline_pct``, pinned for one
flagship 8-frame block."""

import importlib.util

from tiny import RXBENCH


def _metric():
    path = RXBENCH / "metrics" / "viterbi_roofline_pct.py"
    spec = importlib.util.spec_from_file_location("vr", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flagship_block_work():
    from rxbench.spec import Spec
    v = _metric()
    ens = Spec().config("flagship")["receivers"][0]["ensemble"]
    lanes = v.lanes(ens, 8)
    # 32 FIC codewords (2304 soft, 768 data bits), 9 x 32 MSC codewords
    # (EEP 3-A 128 kbit/s: 96 CUs = 6144 soft bits, 3072 data bits)
    assert lanes.count((2304, 768)) == 32
    assert lanes.count((6144, 3072)) == 288 and len(lanes) == 320
    ops, nbytes = v.work(lanes)
    steps = 32 * 774 + 288 * 3078
    assert steps == 911_232
    assert ops == 240 * steps == 218_695_680
    assert nbytes == 4 * (32 * 2304 + 288 * 6144) + 32 * 768 + 288 * 3072
    assert nbytes == 8_282_112
    # bound by operations: 3.264 us at 67 TFLOP/s
    assert abs(v.least_s(ops, nbytes) - ops / 67e12) < 1e-15


def test_fic_only_and_option_b():
    v = _metric()
    assert v.work(v.lanes(None, 8)) == (240 * 32 * 774,
                                        32 * (4 * 2304 + 768))
    spec = {"subchannels": [{"protection": "EEP-2B", "kbps": 64}]}
    # EEP 2-B: 21 CUs per 32 kbit/s
    assert (42 * 64, 64 * 24) in v.lanes(spec, 1)


def test_roofline_reads_named_kernels_only():
    from rxbench.record import DeviceTrace, Record
    v = _metric()
    ens = {"subchannels": []}
    ev = [("(anonymous namespace)::acs4_kernel(float const*, int const*)",
           0, 1000),
          ("traceback4_kernel(unsigned int const*)", 1000, 1500),
          ("fft_kernel", 1500, 9000)]
    dev = DeviceTrace(events=ev, window=(0, 9000), offset=0, handovers=1,
                      steps=[(ens, 1)])
    r = Record(config={}, traffic={"frames_per_block": 8}, setup_s=1,
               air_s=0.768, ensembles=1, window=(0, 1), handovers=[(0, 1)],
               device=dev)
    least = v.least_s(*v.work(v.lanes(ens, 8)))
    assert abs(v.read(r) - 100 * least / 1.5e-6) < 1e-9
    dev.events = ev[2:]
    assert v.read(r) is None
    assert v.kernel_name("void at::native::elementwise_kernel<128, 2>(int)") \
        == ""
    assert v.kernel_name("traceback2_kernel(unsigned int const*)") == \
        "traceback2_kernel"


def test_uep_lanes_count_table_31():
    """A UEP lane is its Table 31 row's CUs x 64 soft bits (padding bits
    included) and ``kbps`` x 24 data bits, four codewords a frame."""
    v = _metric()
    spec = {"subchannels": [{"protection": "UEP-3", "kbps": 128},
                            {"protection": "UEP-3", "kbps": 192},
                            {"protection": "UEP-3", "kbps": 80},
                            {"protection": "UEP-1", "kbps": 128}]}
    lanes = v.lanes(spec, 2)
    assert lanes[8:] == ([(96 * 64, 3072)] * 8 + [(140 * 64, 4608)] * 8
                         + [(58 * 64, 1920)] * 8 + [(140 * 64, 3072)] * 8)
