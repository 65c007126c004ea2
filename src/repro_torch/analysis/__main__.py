import sys

from repro_torch.analysis.report import run

if __name__ == "__main__":
    sys.exit(run())
