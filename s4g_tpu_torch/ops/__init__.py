from .gather import gather_points, group_points, gather_knn
from .neighbors import (ball_query, ball_query_grouped, three_nn,
                        pairwise_sqdist)
from .sampling import farthest_point_sample
from .interpolate import feature_interpolate
