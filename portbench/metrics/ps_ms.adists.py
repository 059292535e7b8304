"""Device ms a step of what the program's ``adists.ps`` spans launch: γ
and the ps cascade step of every stage, windowed and global (fp32; the
cascade's resize matrices included)."""
from portbench.traces import device_ms_per_step


def read(run):
    return device_ms_per_step(run.trace, "adists.ps")
