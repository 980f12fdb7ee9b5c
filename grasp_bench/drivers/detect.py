"""`detect`: a closed loop of one caller, one camera: each call is
`GraspDetector.detect` of the next pool scene, the next sent when its
grasps are on the host."""

import time

from ..serving import Detector


class Driver(Detector):

    def _call(self, i):
        (cloud,) = self.clouds(i)
        result = self.det.detect(cloud, **self.kwargs)
        return [result], self.det.last_num_valid

    def _loop(self, seconds, run):
        start = time.perf_counter()
        end = start + seconds
        while True:
            t0 = time.perf_counter()
            results, num_valid = self._call(self.calls)
            t1 = time.perf_counter()
            rec = {"t0": t0, "t1": t1, "items": 1}
            if self.trace:
                rec["timings"] = dict(self.det.timings)
            run.records.append(rec)
            self._keep(self.calls, results, num_valid)
            self.calls += 1
            if t1 >= end:
                break
        run.window = (start, t1)
