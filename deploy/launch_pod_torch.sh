#!/usr/bin/env bash
# Launch the PyTorch/CUDA port's service (aligner_tpu_torch) across hosts.
#
# The counterpart of deploy/launch_pod.sh for the port: host 0 runs the
# state endpoint (the work queue and results store served over HTTP from
# its local sqlite) and the dispatcher HTTP API; every host runs a worker
# on its card.  Remote hosts reach the state over the network, so adding a
# machine is running this script with the next index.  No shared
# filesystem is involved.
#
# Usage:
#   deploy/launch_pod_torch.sh <num_hosts> <this_host_index> <coordinator_ip>
#
# Env overrides:
#   ALIGNER_DB          host-0 sqlite path (default /srv/aligner/aligner.db)
#   ALIGNER_STATE_PORT  state endpoint port        (default 3031)
#   ALIGNER_HTTP_PORT   dispatcher API port        (default 3030)
#   ALIGNER_DEVICE      the worker's --device: cuda, or cpu for the plain
#                       PyTorch versions           (default cuda)
#   ALIGNER_WORKER_ARGS extra args for the worker  (e.g. test bounds)
#   ALIGNER_NO_WARMUP   set to skip the worker's --warmup
#   ALIGNER_LOG         log level                  (default info)
set -euo pipefail

NUM_HOSTS="${1:?num_hosts}"
HOST_INDEX="${2:?host_index}"
COORDINATOR="${3:?coordinator_ip}"

STATE_PORT="${ALIGNER_STATE_PORT:-3031}"
HTTP_PORT="${ALIGNER_HTTP_PORT:-3030}"
DEVICE="${ALIGNER_DEVICE:-cuda}"
export ALIGNER_LOG="${ALIGNER_LOG:-info}"

# Fail closed: a multi-host launch binds the state endpoint on 0.0.0.0,
# and without a token it would accept unauthenticated RPCs (read/corrupt
# the results DB, drain the queue) from anything with network reach.
# Export the same ALIGNER_STATE_TOKEN on every host, or set
# ALIGNER_ALLOW_INSECURE=1 for an isolated/trusted network.
if [ -z "${ALIGNER_STATE_TOKEN:-}" ] && [ "$NUM_HOSTS" -gt 1 ]; then
  if [ "${ALIGNER_ALLOW_INSECURE:-0}" = "1" ]; then
    echo "WARNING: ALIGNER_STATE_TOKEN unset; proceeding because" >&2
    echo "WARNING: ALIGNER_ALLOW_INSECURE=1 — the state endpoint at" >&2
    echo "WARNING: ${COORDINATOR}:${STATE_PORT} accepts unauthenticated writes." >&2
  else
    echo "ERROR: multi-host launch (NUM_HOSTS=$NUM_HOSTS) without" >&2
    echo "ERROR: ALIGNER_STATE_TOKEN. Export the same shared secret on" >&2
    echo "ERROR: every host, or set ALIGNER_ALLOW_INSECURE=1 for an" >&2
    echo "ERROR: isolated network." >&2
    exit 1
  fi
fi

# A single-host launch without a token binds the state endpoint to
# loopback only: workers on this host reach it via 127.0.0.1.
STATE_BIND="0.0.0.0"
if [ "$NUM_HOSTS" = "1" ] && [ -z "${ALIGNER_STATE_TOKEN:-}" ]; then
  STATE_BIND="127.0.0.1"
fi

if [ "$HOST_INDEX" = "0" ]; then
  export ALIGNER_DB="${ALIGNER_DB:-/srv/aligner/aligner.db}"
  mkdir -p "$(dirname "$ALIGNER_DB")"
  python -m aligner_tpu_torch.service.netstate \
    --host "$STATE_BIND" --port "$STATE_PORT" --db "$ALIGNER_DB" &
  # wait for the state endpoint before starting consumers
  python - "$STATE_PORT" <<'PY'
import sys, time, urllib.request
port = sys.argv[1]
for _ in range(100):
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=1)
        break
    except Exception:
        time.sleep(0.2)
else:
    raise SystemExit("state endpoint did not come up")
PY
  python -m aligner_tpu_torch.service.dispatcher \
    --host 0.0.0.0 --port "$HTTP_PORT" &
else
  # remote host: all state lives behind the host-0 endpoint
  export ALIGNER_DB="http://${COORDINATOR}:${STATE_PORT}"
  # wait for host 0's endpoint before the worker registers
  python - "$ALIGNER_DB" <<'PY'
import sys, time, urllib.request
url = sys.argv[1]
for _ in range(300):
    try:
        urllib.request.urlopen(f"{url}/healthz", timeout=1)
        break
    except Exception:
        time.sleep(0.5)
else:
    raise SystemExit(f"state endpoint {url} did not come up")
PY
fi

# --warmup: get the kernels ready against pending job shapes before the
# first lease is taken (ALIGNER_NO_WARMUP=1 skips it); the worker resolves
# its device and loads the kernel library before it registers, so a host
# without a working card claims nothing
# shellcheck disable=SC2086
exec python -m aligner_tpu_torch.service.worker \
  --name "node-host${HOST_INDEX}" --device "$DEVICE" \
  $([ -z "${ALIGNER_NO_WARMUP:-}" ] && echo --warmup) \
  ${ALIGNER_WORKER_ARGS:-}
