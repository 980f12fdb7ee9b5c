"""`detect_batch`: a closed loop of calls of B scenes (a multi-camera
cell or a grasp server): each call is `GraspDetector.detect_batch` of the
next B pool scenes, the next sent when all B scenes' grasps are on the
host."""

from .detect import Driver as _Detect


class Driver(_Detect):

    def _call(self, i):
        results = self.det.detect_batch(self.clouds(i), **self.kwargs)
        return results, list(self.det.last_num_valid)

    def _loop(self, seconds, run):
        super()._loop(seconds, run)
        for rec in run.records:
            rec["items"] = self.batch
