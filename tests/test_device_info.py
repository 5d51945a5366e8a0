"""utils/device.card_info: the card's name and power limit beside every
number, read from nvidia-smi; an honest marker where there is none."""

import os
import stat

from hpccg_tpu.utils.device import card_info


def test_card_info_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert card_info() == "no nvidia-smi"


def test_card_info_reads_first_card(monkeypatch, tmp_path):
    fake = tmp_path / "nvidia-smi"
    fake.write_text(
        "#!/bin/sh\n"
        'echo "NVIDIA H200, 700.00 W"\n'
        'echo "NVIDIA H200, 650.00 W"\n'
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep + os.environ["PATH"])
    assert card_info() == "NVIDIA H200, 700.00 W"


def test_card_info_tool_failure(monkeypatch, tmp_path):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\nexit 9\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep + os.environ["PATH"])
    assert card_info() == "no nvidia-smi"
