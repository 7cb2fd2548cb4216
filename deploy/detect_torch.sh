#!/bin/bash
# (bash, not sh: `wait -n` below is a bashism)
# Streaming detect supervisor for a receiver node / GPU host, on the
# PyTorch + CUDA port (the port's counterpart of deploy/detect.sh).
#
# Mirrors the reference's rpi/detect.sh: wait for NTP coarse time sync,
# create a FIFO between the capture process and the detector so neither
# blocks the other, and kill the whole job group if any stage dies.
#
# DEVICE (default cuda): where detect runs; `cuda` without a card makes
# detect exit with an error (it never falls back to the CPU).
# PYTHON (default python): the interpreter that has torch installed.

set -e

CONFIG=${CONFIG:-/etc/thrifty-tpu/detector.cfg}
OUTPUT=${OUTPUT:-/var/lib/thrifty-tpu/rx.toad}
FIFO=${FIFO:-/tmp/thrifty-tpu-capture.fifo}
DEVICE=${DEVICE:-cuda}
PYTHON=${PYTHON:-python}

# The output directory must exist (systemd's StateDirectory covers the
# default; this covers custom OUTPUT paths and standalone runs).
mkdir -p "$(dirname "$OUTPUT")"
CAPTURE_CMD=${CAPTURE_CMD:-"rtl_sdr -f 433.83M -s 2.4M -g 29 -"}

# Wait for NTP synchronisation: the matchmaker needs wall clocks aligned
# to well under its 0.2 s window.
if command -v chronyc >/dev/null 2>&1; then
    until chronyc waitsync 1 0.1 >/dev/null 2>&1; do
        echo "waiting for NTP sync..." >&2
        sleep 5
    done
elif command -v ntp-wait >/dev/null 2>&1; then
    ntp-wait -v || true
fi

# Networked SDR mode: with RTL_TCP=host:port set, skip the FIFO/capture
# subprocess entirely -- detect pulls the live stream itself and
# survives radio-server restarts.
# DEVICE_UNFOLD=1: overlap-save on the card (1.43x less host->device
# traffic, no host unfold); incompatible with CARD_OUT (needs host
# rows), so only applied when no card tee is requested.
UNFOLD=()
if [ -n "$DEVICE_UNFOLD" ] && [ -z "$CARD_OUT" ]; then
    UNFOLD=(--device-unfold)
fi

if [ -n "$RTL_TCP" ]; then
    exec "$PYTHON" -m thrifty_tpu_torch.cli detect --rtl-tcp "$RTL_TCP" \
        --reconnect "${RECONNECT:-10}" -a "$OUTPUT" -c "$CONFIG" --quiet \
        --device "$DEVICE" "${UNFOLD[@]}" ${CARD_OUT:+--card-out "$CARD_OUT"}
fi

rm -f "$FIFO"
mkfifo "$FIFO"

cleanup() {
    # `kill 0` signals the whole process group INCLUDING this shell:
    # ignore the re-delivered INT/TERM (re-entering cleanup would
    # livelock the shutdown until systemd's TimeoutStopSec SIGKILL;
    # defaulting it would kill the shell before the FIFO is removed).
    trap '' INT TERM
    trap - EXIT
    kill 0 2>/dev/null || true
    rm -f "$FIFO"
}
trap cleanup EXIT INT TERM

# capture -> FIFO -> detect (append mode: restartable mid-capture).
# CARD_OUT (optional): also archive corr-detected blocks as a sparse
# .card capture for later re-analysis (fastdet's tee).
EXTRA=()
if [ -n "$CARD_OUT" ]; then
    EXTRA=(--card-out "$CARD_OUT")
fi
$CAPTURE_CMD > "$FIFO" &
"$PYTHON" -m thrifty_tpu_torch.cli detect "$FIFO" --raw -a "$OUTPUT" \
    -c "$CONFIG" --quiet --device "$DEVICE" "${UNFOLD[@]}" "${EXTRA[@]}" &

wait -n
echo "pipeline stage exited; shutting down" >&2
