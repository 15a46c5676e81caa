"""One serving-fleet replica process of the port for the cross-process
drill (tests/test_torch_fleet_router.py spawns it).

Config rides env vars (the dist-worker convention):

- ``FLEET_REGISTRY``     shared ModelRegistry root (required)
- ``FLEET_MODEL``        registry model name (default ``drill``)
- ``FLEET_PORT``         port to bind (default 0 = ephemeral)
- ``FLEET_VERSION``      version to serve (default ``current``)
- ``FLEET_PUBLISH_AOT``  '1' = publish the warm AOT bundle back to the
                         registry (the first replica does; later
                         replicas then cold-start with 0 signature misses)
- ``FLEET_DEVICE``       ``cpu`` (default here) or ``gpu``

Prints one ``FLEET_REPLICA_READY {json}`` line (bound port, pid, active
version, cold-start misses, builds and captures), serves until SIGTERM or
a router ``stop`` op, drains, and exits with the resumable code (75).
"""
import os
import sys


def main():
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(1)
    from mxnet_tpu_torch.serving import replica_main
    replica_main(
        os.environ["FLEET_REGISTRY"],
        os.environ.get("FLEET_MODEL", "drill"),
        port=int(os.environ.get("FLEET_PORT", "0")),
        version=os.environ.get("FLEET_VERSION", "current"),
        publish_aot=os.environ.get("FLEET_PUBLISH_AOT", "0") == "1",
        device=os.environ.get("FLEET_DEVICE", "cpu"),
    )


if __name__ == "__main__":
    main()
