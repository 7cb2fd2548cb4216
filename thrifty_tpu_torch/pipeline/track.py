"""Position tracking: Kalman smoothing of per-transmission fixes.

Resolves the reference's TODO (pos_est.py:148 "apply Kalmin filter or
something to average out the position estimates (move to separate
module)"): a constant-velocity Kalman filter per transmitter, with the
measurement covariance scaled by each fix's DOP, turns raw per-burst
fixes into a smoothed track with velocity estimates.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

TRACK_FIELDS = ("timestamp", "tx", "x", "y", "vx", "vy", "speed")


class KalmanTracker:
    """Constant-velocity Kalman filter for one transmitter's fixes.

    State [x, y, vx, vy]; process noise is parametrized by an assumed
    acceleration std (m/s^2), measurement noise by a base position std
    (m) scaled by each fix's DOP.
    """

    def __init__(self, accel_std=1.0, meas_std=5.0):
        self.accel_std = accel_std
        self.meas_std = meas_std
        self.t = None
        self.state = None  # [4]
        self.cov = None    # [4, 4]

    def update(self, timestamp, xy, dop=1.0):
        """Fold in one fix; returns the filtered [x, y, vx, vy]."""
        z = np.asarray(xy, dtype=np.float64)
        if self.state is None:
            self.t = float(timestamp)
            self.state = np.array([z[0], z[1], 0.0, 0.0])
            # Initialize the position variance at the FIRST fix's own
            # measurement uncertainty (DOP-scaled, like every later
            # update's R): seeding with the bare meas_std would
            # over-trust a bad-geometry first fix and keep the gain
            # too low for the good fixes that follow.
            init_std = self.meas_std * max(float(dop), 0.1)
            self.cov = np.diag([init_std**2, init_std**2,
                                100.0, 100.0])
            return self.state.copy()

        # A late-settling older group can arrive out of order; never
        # extrapolate backwards (dt=0 degrades to a pure measurement
        # update and leaves the clock at the newest fix).
        dt = max(float(timestamp) - self.t, 0.0)
        self.t = max(self.t, float(timestamp))
        f = np.eye(4)
        f[0, 2] = f[1, 3] = dt
        # White-acceleration process noise.
        q1, q2, q3 = dt**4 / 4, dt**3 / 2, dt**2
        q = self.accel_std**2 * np.array([
            [q1, 0, q2, 0],
            [0, q1, 0, q2],
            [q2, 0, q3, 0],
            [0, q2, 0, q3],
        ])
        state = f @ self.state
        cov = f @ self.cov @ f.T + q

        h = np.zeros((2, 4))
        h[0, 0] = h[1, 1] = 1.0
        r = np.eye(2) * (self.meas_std * max(float(dop), 0.1)) ** 2
        innov = z - h @ state
        s = h @ cov @ h.T + r
        k = cov @ h.T @ np.linalg.inv(s)
        self.state = state + k @ innov
        self.cov = (np.eye(4) - k @ h) @ cov
        return self.state.copy()


def update_states(trackers, fixes, accel_std=1.0, meas_std=5.0):
    """Fold fixes into per-transmitter trackers, in timestamp order.

    ``trackers`` is a mutable {txid: KalmanTracker}.  Yields
    (timestamp, tx, state[4]) -- the shared core of the batch CLI and
    the live server.
    """
    order = np.argsort(fixes["timestamp"], kind="stable")
    for row in fixes[order]:
        # dop <= 0 marks singular geometry (pos.dop returned -1) and a
        # NaN dop an ill-conditioned one: the fix's error is unbounded
        # either way, so skip it rather than weight it (written so NaN
        # fails the condition too).
        if not (row["dop"] > 0):
            continue
        tx = int(row["tx"])
        tracker = trackers.setdefault(
            tx, KalmanTracker(accel_std, meas_std))
        state = tracker.update(float(row["timestamp"]),
                               [row["x"], row["y"]], float(row["dop"]))
        yield float(row["timestamp"]), tx, state


def track_positions(results, accel_std=1.0, meas_std=5.0):
    """Run per-transmitter trackers over a position result array.

    ``results`` is the structured array from pos.solve (2-D fixes).
    Returns a structured array with smoothed positions + velocities.
    """
    rows = [
        (ts, tx, s[0], s[1], s[2], s[3], float(np.hypot(s[2], s[3])))
        for ts, tx, s in update_states({}, results, accel_std, meas_std)
    ]
    return np.array(rows, dtype=[
        ("timestamp", "f8"), ("tx", "i4"), ("x", "f8"), ("y", "f8"),
        ("vx", "f8"), ("vy", "f8"), ("speed", "f8")])


def format_track_row(timestamp, tx, state):
    """One .track text line from a filtered [x, y, vx, vy] state."""
    return "{:.6f} {} {:.3f} {:.3f} {:.3f} {:.3f} {:.3f}".format(
        float(timestamp), int(tx), state[0], state[1], state[2],
        state[3], float(np.hypot(state[2], state[3])))


def live_update(trackers, fixes, accel_std=1.0, meas_std=5.0):
    """update_states, yielding formatted .track lines (live server)."""
    for ts, tx, state in update_states(trackers, fixes, accel_std,
                                       meas_std):
        yield format_track_row(ts, tx, state)


def save_tracks(stream_or_path, tracks):
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "w") as f:
            return save_tracks(f, tracks)
    for row in tracks:
        state = (row["x"], row["y"], row["vx"], row["vy"])
        stream_or_path.write(
            format_track_row(row["timestamp"], row["tx"], state) + "\n")


def _main(argv=None):
    from thrifty_tpu_torch.pipeline import pos as pos_mod

    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("pos", nargs="?", type=str, default="data.pos")
    parser.add_argument("-o", "--output", type=str, default="data.track")
    parser.add_argument("--accel-std", type=float, default=1.0,
                        help="process noise: acceleration std (m/s^2)")
    parser.add_argument("--meas-std", type=float, default=5.0,
                        help="measurement noise: position std per unit "
                             "DOP (m)")
    args = parser.parse_args(argv)

    results = pos_mod.load_positions(
        sys.stdin if args.pos == "-" else args.pos)
    tracks = track_positions(results, args.accel_std, args.meas_std)
    print("tracked {} fixes across {} transmitter(s)".format(
        len(tracks), len(np.unique(tracks["tx"]))))
    if args.output == "-":
        save_tracks(sys.stdout, tracks)
    else:
        save_tracks(args.output, tracks)


if __name__ == "__main__":
    sys.exit(_main())
