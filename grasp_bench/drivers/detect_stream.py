"""`detect_stream`: one camera's endless frames through
`GraspDetector.detect_stream` at the traffic's depth (frames in flight);
the window counts the frames yielded.  In a traced run each frame's
submit is wrapped to count the host's waits on the device."""

import itertools
import time

from ..serving import Detector, count_syncs


class Driver(Detector):

    def _frames(self, first):
        for i in itertools.count(first):
            yield self.clouds(i)[0]

    def _stream(self, first):
        return self.det.detect_stream(self._frames(first),
                                      depth=self.traffic["depth"],
                                      **self.kwargs)

    def _call(self, i):
        # One frame alone (warm-up): a stream of one.
        results = list(itertools.islice(
            self.det.detect_stream([self.clouds(i)[0]],
                                   depth=self.traffic["depth"],
                                   **self.kwargs), 1))
        return results, self.det.last_num_valid

    def _loop(self, seconds, run):
        submit = self.det._submit
        counting = self.trace and self.device == "cuda"
        if counting:
            self.det._submit = count_syncs(submit)
        stream = self._stream(0)
        start = time.perf_counter()
        end = start + seconds
        try:
            t0 = start
            for result in stream:
                t1 = time.perf_counter()
                run.records.append({"t0": t0, "t1": t1, "items": 1})
                self._keep(self.calls, [result], self.det.last_num_valid)
                self.calls += 1
                t0 = t1
                if t1 >= end:
                    break
        finally:
            stream.close()
            if counting:
                run.syncs = self.det._submit.counts
                self.det._submit = submit
        run.window = (start, t1)

    def stretch(self):
        n = self.traffic["profile_calls"]
        for _ in itertools.islice(self._stream(self.calls), n):
            pass
        self.calls += n
