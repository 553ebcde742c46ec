"""Mouse-coordinate helper — equivalent of reference ``getcors.py``.

Prints the live cursor position every 0.5 s for calibrating the capture
region. Requires a desktop environment (pyautogui); degrades gracefully.
"""

from __future__ import annotations

import time


def main(argv=None) -> int:
    try:
        import pyautogui  # type: ignore
    except ImportError:
        print("pyautogui is not installed; getcors requires a desktop environment")
        return 1
    try:
        while True:
            x, y = pyautogui.position()
            print(f"X={x}, Y={y}")
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
